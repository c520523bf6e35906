"""Relative bonds, the source's `Yuma4`: the carried bonds decay at the
EMA rate and each validator buys into a miner at most its weight times
the rate, up to a whole bond; a validator's dividend is its stake times
its bonds weighted by the miners' incentive."""

import torch

#: The decay, `1 - B`, its clamp, the purchase's multiply and min, the add
#: and the clamp.
OPS_PER_CELL = 7


def step(q, B_old, p):
    B_prev = torch.zeros_like(q.W_n) if B_old is None else B_old
    B_decayed = B_prev * (1 - q.rate)
    purchase = torch.minimum(q.rate * q.W_n, torch.clamp(1 - B_decayed, min=0))
    B = torch.clamp(B_decayed + purchase, max=1)
    return B, q.S_n * (B * q.incentive.unsqueeze(-2)).sum(dim=-1)
