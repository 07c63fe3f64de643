"""Test-input prioritizers: Coverage-Additional Method (CAM), host and device.

- ``cam_order``: own copy of the JAX package's vectorised host CAM (numpy):
  repeatedly pick the sample covering the most not-yet-covered sections
  (ties: lowest index); stop when the best adds nothing or everything is
  covered; the rest follow in descending score order.
- ``device_cam_greedy``: the greedy phase in torch on packed profiles, on
  the profiles' device (the JAX package runs it as a ``lax.while_loop``).
  Torch has no popcount and no uint32 bitwise ops on the CPU, so words are
  int32 and counted with a SWAR popcount. Each step is a full sweep with no
  host sync; whether the best gain is still positive is read only every
  ``check_every`` picks (steps after the gain reaches 0 change nothing).

The greedy result depends only on which bits each row shares with the
covered set, never on where in the row a bit sits, so any bit layout that
is the same for every row gives the same picks (``words_from_packbits``).
"""

from typing import Generator

import numpy as np
import torch


def cam(scores: np.ndarray, profiles: np.ndarray) -> Generator[int, None, None]:
    """Yield sample indexes by greedy additional coverage, then by score."""
    for x in cam_order(np.asarray(scores), np.asarray(profiles)):
        yield int(x)


def cam_order(scores: np.ndarray, profiles: np.ndarray) -> np.ndarray:
    """Full CAM order as an index array (vectorised host implementation)."""
    scores = np.asarray(scores).copy()
    profiles = np.asarray(profiles).reshape((profiles.shape[0], -1)).copy()
    num_coverable = profiles.sum(axis=1).astype(np.int64)
    remaining = int(profiles.shape[1])
    picked = []
    while True:
        nxt = int(np.argmax(num_coverable))
        newly_covered = int(num_coverable[nxt])
        if newly_covered == 0:
            break
        picked.append(nxt)
        covering_columns = profiles[nxt].nonzero()[0]
        remaining -= newly_covered
        num_coverable -= profiles[:, covering_columns].sum(axis=1)
        profiles[:, covering_columns] = False
        if remaining == 0:
            break
    return _with_score_tail(scores, np.asarray(picked, dtype=np.int64))


def _with_score_tail(scores: np.ndarray, picked: np.ndarray) -> np.ndarray:
    """Append the non-picked samples in descending original-score order.

    Picked samples get the sentinel ``min - 2`` before the argsort (the
    reference's tie order) and are then removed by an explicit mask, which
    stays right where scores contain -inf.
    """
    scores = np.asarray(scores).copy()
    picked = np.asarray(picked, dtype=np.int64)
    scores[picked] = scores.min() - 2
    rest = np.argsort(-scores)
    is_picked = np.zeros(scores.shape[0], dtype=bool)
    is_picked[picked] = True
    rest = rest[~is_picked[rest]]
    order = np.concatenate([picked, rest.astype(np.int64)])
    if order.shape[0] != scores.shape[0]:
        raise RuntimeError("CAM order lost samples")
    return order


def pack_profiles(profiles: torch.Tensor) -> torch.Tensor:
    """Boolean ``[n, w]`` profiles as int32 words ``[n, ceil(w/32)]``, bit j
    of word k = section 32*k + j (the JAX package's ``pack_profiles``
    layout, with int32 in place of uint32)."""
    profiles = profiles.reshape(profiles.shape[0], -1).to(torch.int64)
    n, w = profiles.shape
    pad = (-w) % 32
    if pad:
        profiles = torch.cat([profiles, profiles.new_zeros(n, pad)], dim=1)
    shifts = torch.arange(32, dtype=torch.int64, device=profiles.device)
    words = (profiles.reshape(n, -1, 32) << shifts).sum(dim=2)
    # two's complement: bit 31 set means a negative int32
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def words_from_packbits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``packbits`` rows reinterpreted as int32 words (zero-padded)."""
    n, nbytes = packed.shape
    pad = (-nbytes) % 4
    if pad:
        packed = torch.cat([packed, packed.new_zeros(n, pad)], dim=1)
    return packed.contiguous().view(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 (SWAR; arithmetic shifts are masked away)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def device_cam_greedy(words: torch.Tensor, check_every: int = 32) -> torch.Tensor:
    """Greedy CAM picks (int64, in order) over int32 packed profiles.

    Tie-break: lowest index (``torch.argmax`` returns the first maximum).
    """
    n = words.shape[0]
    covered = torch.zeros(words.shape[1], dtype=torch.int32, device=words.device)
    picked = torch.full((n,), -1, dtype=torch.int64, device=words.device)
    minus_one = torch.tensor(-1, dtype=torch.int64, device=words.device)
    count = 0
    while count < n:
        steps = min(check_every, n - count)
        for step in range(steps):
            gains = popcount32(words & ~covered).sum(dim=1)
            nxt = torch.argmax(gains).reshape(1)
            do_pick = gains.gather(0, nxt)[0] > 0
            row = words.index_select(0, nxt)[0]
            covered = torch.where(do_pick, covered | row, covered)
            picked[count + step] = torch.where(do_pick, nxt[0], minus_one)
        count += steps
        if int(picked[count - 1]) < 0:
            break
    return picked[picked >= 0]


def cam_order_device(scores: np.ndarray, words: torch.Tensor) -> np.ndarray:
    """CAM order with the greedy phase on the words' device; the score tail
    is computed on the host."""
    picked = device_cam_greedy(words).cpu().numpy()
    return _with_score_tail(np.asarray(scores), picked)

