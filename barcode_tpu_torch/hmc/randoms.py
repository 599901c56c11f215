"""Counter-based per-chain randomness, shared by the dense and the sharded
sampler.

Every chain carries an integer seed (`ChainState.seed`, the `seed` entry of
a sharded state dict) where the JAX package keeps a PRNG key.  An attempt
draws from generators seeded by (chain seed, attempt count, stream), so a
chain's draws depend on its seed and its attempt count only: not on the
other chains of its batch, not on how many grid ranks share its field, and
a checkpoint needs no generator state.  The streams:

  * `UNIFORM_STREAM` (0): the chain's three uniforms, `torch.rand(3)` in
    the order u_neps, u_eps, u_acc; the same on every grid rank;
  * `momentum_stream(d)` = 1 + d: grid rank d's slab of the momentum white
    noise.  The dense sampler holds the whole grid as grid rank 0, so a
    one-rank sharded chain and a dense chain draw the same noise;
  * `REAL_MASS_STREAM` (2^64 - 1): the white noise of a real-space mass
    part (mass types 0, 5, 6 and 60, dense sampler only).  No grid rank
    reaches it: that would take 2^64 - 2 of them.

The same triple gives the same bits on one device type; the CPU and CUDA
generators give other values.  The JAX package splits a threefry key
instead (sampler.py:116), so the two packages agree in distribution, not in
value.
"""
from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1

UNIFORM_STREAM = 0
REAL_MASS_STREAM = _MASK64


def momentum_stream(grid_rank: int) -> int:
    """The stream of grid rank `grid_rank`'s momentum white noise."""
    return 1 + grid_rank


def _mix(*words: int) -> int:
    """splitmix64 over the words: a well-spread 63-bit generator seed."""
    z = 0x9E3779B97F4A7C15
    for w in words:
        z = (z ^ (int(w) & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
        z ^= z >> 31
    return z >> 1


def attempt_generator(seed: int, count: int, stream: int, device):
    """The generator of one (chain seed, attempt count, stream) triple."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(seed, count, stream))
    return gen


def chain_keys(seeds, counts):
    """The chains' (seed, attempt count) pairs as host ints (a device sync
    for tensors on the card)."""
    return list(zip(torch.as_tensor(seeds).tolist(),
                    torch.as_tensor(counts).tolist()))


def uniforms(keys, device):
    """(C, 3) uniforms [0, 1) of the chains' attempts (`chain_keys`): u_neps,
    u_eps, u_acc in the columns."""
    return torch.stack([
        torch.rand(3, generator=attempt_generator(s, n, UNIFORM_STREAM,
                                                  device), device=device)
        for s, n in keys])


def white(keys, stream: int, shape, device):
    """(C,) + shape unit normal noise of the chains' attempts (`chain_keys`)
    from `stream`."""
    return torch.stack([
        torch.randn(tuple(shape), generator=attempt_generator(s, n, stream,
                                                              device),
                    device=device)
        for s, n in keys])
