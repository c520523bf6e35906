"""The frozen public API surface, version 1, of the port.

Mirrors the JAX package's `v1` (and the reference's contract, reference
README.md:10-18): everything under `v1` is stable; internals under the
other subpackages may change freely. Import the api module explicitly:

    from yuma_simulation_tpu_torch.v1 import api
"""
