"""The bonds models of the plain reference, one file each, found by the
name a configuration file gives under `bonds_model`.

A model's file gives:

- `OPS_PER_CELL`: the vector operations it costs a `[V, M]` cell in one
  epoch (the roofline metrics add them to the epoch's shared
  `yuma.EPOCH_OPS_PER_CELL`);
- `step(q, B_old, p) -> (B, D)`: one epoch's bonds `[..., V, M]` and raw
  dividends `[..., V]`, from the epoch's quantities `q` (`W_n`, `S_n`,
  `C`, `W_c`, `incentive`, `rate`; see `yuma.epoch`), the carried bonds
  (None on the first epoch) and the configuration's `yuma.Params`.

A version whose bonds differ from these is added as a file here and a
configuration that names it: no code changes.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType

#: The folder the models are read from.
FOLDER = Path(__file__).resolve().parent
_LOADED: dict = {}


def model(name: str) -> ModuleType:
    """The bonds model `name` (`<FOLDER>/<name>.py`), loaded once."""
    path = FOLDER / f"{name}.py"
    if path not in _LOADED:
        if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not path.is_file():
            raise KeyError(f"no bonds model {name!r} in {FOLDER}")
        spec = importlib.util.spec_from_file_location(f"cudabench_bonds_{name}", path)
        _LOADED[path] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_LOADED[path])
    return _LOADED[path]
