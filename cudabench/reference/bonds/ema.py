"""EMA bonds, the source's `Yuma` (Yuma 1): the bond target is the
stake-weighted share of each miner's penalty-blended weight, moved into
the carried bonds at the EMA rate; a validator's dividend is its bonds
weighted by the miners' incentive."""

import torch

#: The target (the blend: two multiplies and an add; the stake product;
#: the column sum's add; the divide) and the EMA (two multiplies and an add).
OPS_PER_CELL = 6 + 3


def step(q, B_old, p):
    S_col = q.S_n.unsqueeze(-1)
    W_b = (1 - p.bond_penalty) * q.W_n + p.bond_penalty * q.W_c
    B = torch.nan_to_num(S_col * W_b / (S_col * W_b).sum(dim=-2, keepdim=True))
    if B_old is not None:
        B = q.rate * B + (1 - q.rate) * B_old
    return B, (B * q.incentive.unsqueeze(-2)).sum(dim=-1)
