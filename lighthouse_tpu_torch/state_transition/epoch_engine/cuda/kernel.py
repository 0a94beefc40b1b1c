"""The epoch engine's two kernels on the card, their plain PyTorch
versions, and the host entry points that drive them.

Counterpart of ``lighthouse_tpu/state_transition/epoch_engine/kernels.py``:

  k_sums   the six balance reductions of an epoch -> uint64[6]: total
           active balance, the three previous-epoch flag balances
           (unslashed, participating), the current target balance and the
           active count
  k_state  the fused per-validator update -> (new inactivity scores, new
           balances, new effective balances)

Layout: the uint64 planes travel as ``int64`` tensors holding the uint64
bit patterns (``FAR_FUTURE_EPOCH`` is -1), ``slashed`` and the
participation flags as ``uint8``.  The epoch scalars are a CPU ``int64``
tensor of uint64 bit patterns (``{prev, cur}`` for k_sums, the
``N_SCALARS`` layout below for k_state): the C entry reads them on the
host and passes them to the kernel by value.  There is no lane padding:
the TPU kernels pad to a power-of-two bucket, a kernel here takes any n.

The card computes in native uint64.  torch has no uint64 comparisons or
divisions on the CPU, so the plain versions compute on the int64 bit
patterns and reproduce uint64 semantics exactly: comparisons flip the sign
bit of both sides, products and sums wrap, and a quotient comes from the
halved numerator with one correction step.  Divisors are never 0 (the
engine's are all at least 1).

Each wrapper checks device, dtype, shape and contiguity, launches its
kernel (``csrc/k_epoch.cu``) for CUDA tensors and counts the launch in its
``launches`` attribute; for CPU tensors it runs the plain version
(``*_plain``, also callable on CUDA tensors to compare).  A failed build or
launch raises.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ....runtime.tensors import check, empty, on_cpu

#: Participation flag weights (TIMELY_SOURCE, TIMELY_TARGET, TIMELY_HEAD)
#: over WEIGHT_DENOMINATOR = 64.
FLAG_WEIGHTS = (14, 26, 14)
WEIGHT_DENOMINATOR = 64

# Packed scalar-vector layout for k_state (all uint64; kernels.py:47-52
# and csrc/k_epoch.cu).
(S_PREV, S_CUR, S_LEAK, S_PER_INCR, S_TOTAL_INCR,
 S_PART0, S_PART1, S_PART2, S_BIAS, S_RECOVERY, S_INACT_DENOM,
 S_ADJUSTED, S_TOTAL_ACTIVE, S_INCR, S_MAX_EFF, S_DOWN, S_UP,
 S_SLASH_WD) = range(18)
N_SCALARS = 18

M64 = (1 << 64) - 1
_SIGN = -(1 << 63)
_LOW63 = (1 << 63) - 1


# --- uint64 on int64 bit patterns --------------------------------------------


def as_i64(value: int) -> int:
    """A uint64 value -> its int64 bit pattern."""
    value &= M64
    return value - (1 << 64) if value >> 63 else value


def as_u64(value: int) -> int:
    """An int64 bit pattern -> its uint64 value."""
    return value & M64


def _key(x):
    """Order-preserving map of uint64 (tensor bit patterns or a Python
    uint64 int) onto int64."""
    if isinstance(x, int):
        return as_u64(x) - (1 << 63)
    return x ^ _SIGN


def _lt(a, b):
    return _key(a) < _key(b)


def _le(a, b):
    return _key(a) <= _key(b)


def _min(a, b):
    return torch.where(_lt(a, b), a, b)


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """x // d for uint64 bit patterns x and a uint64 int 1 <= d."""
    if d >= 1 << 63:
        return (~_lt(x, d)).to(torch.int64)
    q = (((x >> 1) & _LOW63) // d) << 1
    return q + (~_lt(x - q * d, d)).to(torch.int64)


def _mod(x: torch.Tensor, d: int) -> torch.Tensor:
    return x - _div(x, d) * as_i64(d)


def _scalars(scal: torch.Tensor) -> list:
    return [as_u64(v) for v in scal.tolist()]


# --- Plain versions ----------------------------------------------------------


def k_sums_plain(eff, act, exitp, slashed, pflags, cflags, scal):
    prev, cur = _scalars(scal)
    active_cur = _le(act, cur) & _lt(cur, exitp)
    active_prev = _le(act, prev) & _lt(prev, exitp)
    unslashed = slashed == 0

    def total(mask):
        return torch.where(mask, eff, 0).sum()

    sums = [total(active_cur)]
    sums += [total(active_prev & unslashed & (((pflags >> f) & 1) != 0))
             for f in range(3)]
    sums.append(total(active_cur & unslashed & (((cflags >> 1) & 1) != 0)))
    sums.append(active_cur.sum())
    return torch.stack(sums).to(torch.int64)


def k_state_plain(eff, bal, slashed, act, exitp, wd, scores, pflags, scal):
    s = _scalars(scal)
    prev, leak, incr = s[S_PREV], s[S_LEAK] != 0, s[S_INCR]
    is_slashed = slashed != 0
    active_prev = _le(act, prev) & _lt(prev, exitp)
    eligible = active_prev | (is_slashed & _lt(prev + 1, wd))
    unslashed = ~is_slashed
    in_target = (((pflags >> 1) & 1) != 0) & active_prev & unslashed

    # Inactivity scores (process_inactivity_updates).
    new_scores = scores
    new_scores = torch.where(eligible & in_target,
                             new_scores - _min(new_scores, 1), new_scores)
    new_scores = torch.where(eligible & ~in_target,
                             new_scores + as_i64(s[S_BIAS]), new_scores)
    if not leak:
        new_scores = torch.where(
            eligible, new_scores - _min(new_scores, as_i64(s[S_RECOVERY])),
            new_scores)

    # Rewards and penalties (process_rewards_and_penalties_altair).
    base = _div(eff, incr) * as_i64(s[S_PER_INCR])
    reward_div = (s[S_TOTAL_INCR] * WEIGHT_DENOMINATOR) & M64
    rewards = torch.zeros_like(bal)
    penalties = torch.zeros_like(bal)
    for f, weight in enumerate(FLAG_WEIGHTS):
        participating = (((pflags >> f) & 1) != 0) & active_prev & unslashed
        if not leak:
            reward = _div(base * weight * as_i64(s[S_PART0 + f]), reward_div)
            rewards = rewards + torch.where(eligible & participating,
                                            reward, 0)
        if f != 2:  # TIMELY_HEAD carries no miss penalty
            penalty = _div(base * weight, WEIGHT_DENOMINATOR)
            penalties = penalties + torch.where(eligible & ~participating,
                                                penalty, 0)
    penalties = penalties + torch.where(
        eligible & ~in_target, _div(eff * new_scores, s[S_INACT_DENOM]), 0)
    b = bal + rewards
    b = b - _min(b, penalties)

    # Slashings sweep (process_slashings), post-registry withdrawable epochs.
    slash_pen = _div(_div(eff, incr) * as_i64(s[S_ADJUSTED]),
                     s[S_TOTAL_ACTIVE]) * as_i64(incr)
    b = torch.where(is_slashed & (wd == as_i64(s[S_SLASH_WD])),
                    b - _min(b, slash_pen), b)

    # Effective-balance hysteresis (process_effective_balance_updates).
    update = (_lt(b + as_i64(s[S_DOWN]), eff)
              | _lt(eff + as_i64(s[S_UP]), b))
    capped = _min(b - _mod(b, incr),
                  torch.full_like(b, as_i64(s[S_MAX_EFF])))
    new_eff = torch.where(update, capped, eff)
    return new_scores, b, new_eff


# --- Wrappers ----------------------------------------------------------------


def _check_lanes(name, n, device, u64=(), u8=()):
    for arg, t in u64:
        check(f"{name} {arg}", t, (n,), torch.int64, device)
    for arg, t in u8:
        check(f"{name} {arg}", t, (n,), torch.uint8, device)


def _check_scalars(name, scal, count):
    check(f"{name} scal", scal, (count,), torch.int64, torch.device("cpu"))


def k_sums(eff, act, exitp, slashed, pflags, cflags, scal):
    """(n,) int64 uint64 planes eff, act, exitp; (n,) uint8 slashed,
    pflags, cflags; scal: CPU int64 {prev, cur} -> (6,) int64.  Replaces
    state_transition/epoch_engine/kernels.py:90 k_sums."""
    n, device = eff.shape[0], eff.device
    _check_lanes("k_sums", n, device,
                 u64=(("eff", eff), ("act", act), ("exitp", exitp)),
                 u8=(("slashed", slashed), ("pflags", pflags),
                     ("cflags", cflags)))
    _check_scalars("k_sums", scal, 2)
    if on_cpu(device):
        return k_sums_plain(eff, act, exitp, slashed, pflags, cflags, scal)
    from ....runtime import build

    if n == 0:
        return torch.zeros(6, dtype=torch.int64, device=device)
    out = empty((6,), torch.int64, device)
    build.call("k_epoch", "k_sums_launch", eff, act, exitp, slashed, pflags,
               cflags, scal, out, n)
    k_sums.launches += 1
    return out


def k_state(eff, bal, slashed, act, exitp, wd, scores, pflags, scal):
    """(n,) int64 uint64 planes eff, bal, act, exitp, wd (post-registry
    withdrawable epochs), scores; (n,) uint8 slashed, pflags; scal: CPU
    int64 (N_SCALARS,) -> (new_scores, new_balances, new_effective),
    each (n,) int64.  Replaces state_transition/epoch_engine/kernels.py:118
    k_state."""
    n, device = eff.shape[0], eff.device
    _check_lanes("k_state", n, device,
                 u64=(("eff", eff), ("bal", bal), ("act", act),
                      ("exitp", exitp), ("wd", wd), ("scores", scores)),
                 u8=(("slashed", slashed), ("pflags", pflags)))
    _check_scalars("k_state", scal, N_SCALARS)
    if on_cpu(device):
        return k_state_plain(eff, bal, slashed, act, exitp, wd, scores,
                             pflags, scal)
    from ....runtime import build

    outs = tuple(empty((n,), torch.int64, device) for _ in range(3))
    if n:
        build.call("k_epoch", "k_state_launch", eff, bal, slashed, act,
                   exitp, wd, scores, pflags, scal, *outs, n)
        k_state.launches += 1
    return outs


for _fn in (k_sums, k_state):
    _fn.launches = 0
KERNELS = {fn.__name__: fn for fn in (k_sums, k_state)}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# --- Host entry points -------------------------------------------------------


def plane(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A snapshot plane on device: uint64 -> int64 bit patterns, bool ->
    uint8, uint8 as it is."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    elif arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    return torch.from_numpy(arr).to(device)


def scalar_tensor(values) -> torch.Tensor:
    """uint64 values -> the CPU int64 tensor the kernels take."""
    return torch.tensor([as_i64(int(v)) for v in values], dtype=torch.int64)


def _to_u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def run_sums(soa, prev: int, cur: int, device: torch.device) -> np.ndarray:
    """``k_sums`` over a snapshot -> uint64[6]."""
    out = k_sums(plane(soa.effective_balance, device),
                 plane(soa.activation_epoch, device),
                 plane(soa.exit_epoch, device), plane(soa.slashed, device),
                 plane(soa.previous_flags, device),
                 plane(soa.current_flags, device), scalar_tensor((prev, cur)))
    return _to_u64(out)


def run_state(soa, wd_post: np.ndarray, scalars, device: torch.device
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``k_state`` over a snapshot -> (new_scores, new_balances,
    new_effective_balances) as uint64 arrays."""
    outs = k_state(plane(soa.effective_balance, device),
                   plane(soa.balance, device), plane(soa.slashed, device),
                   plane(soa.activation_epoch, device),
                   plane(soa.exit_epoch, device), plane(wd_post, device),
                   plane(soa.inactivity_scores, device),
                   plane(soa.previous_flags, device), scalar_tensor(scalars))
    return tuple(_to_u64(t) for t in outs)
