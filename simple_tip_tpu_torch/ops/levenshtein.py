"""Pairwise Levenshtein distances over UTF-8 bytes, on the device.

Counterpart of the JAX package's host kernel (``ops/native`` ``lev_matrix``,
a C++ loop over pairs): the distance counts byte edits (not characters), is
clipped at 255 and stored as uint8, with 0 on the diagonal. Here every pair
of a block of rows against all words runs as one batched dynamic program
over anti-diagonals: cell (i, j) of a pair's table lies on diagonal
``i + j``, and diagonal ``d`` needs only diagonals ``d - 1`` and ``d - 2``,
so each step is a few elementwise ops over ``[pairs, L + 1]``. Words are
padded to the longest word's length ``L``; a pair's distance is read at
cell ``(len a, len b)``, which the padding does not reach.

``levenshtein(a, b)`` is the single pair on the host.
"""

from typing import List, Sequence

import numpy as np
import torch

from simple_tip_tpu_torch.device import DeviceLike, resolve

# Pairs per step of the batched program: at L + 1 = 24 that is ~200 MB of
# int16 diagonals on the card.
PAIRS_PER_BLOCK = 1 << 22
# Pairs per step on the CPU (its memory bandwidth, not its size, bounds it).
CPU_PAIRS_PER_BLOCK = 1 << 18


def _encode(words: Sequence[str]):
    encoded = [w.encode("utf-8") for w in words]
    width = max([len(e) for e in encoded] + [1])
    codes = np.zeros((len(words), width), dtype=np.int16)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    lengths = np.array([len(e) for e in encoded], dtype=np.int64)
    return codes, lengths


def _pair_distances(a, la, b, lb) -> torch.Tensor:
    """Levenshtein distances of the pairs (a[p], b[p]): ``a``/``b`` are
    [P, L] byte codes, ``la``/``lb`` [P] lengths. Returns int16 [P].

    Diagonal ``d`` holds rows i = 0..L (column j = d - i). A cell inside
    the table reads only cells inside it or on its borders, which are set
    on each diagonal, so the cells outside (j < 0 or j > L) hold values
    that no result reads and are not masked.
    """
    pairs, width = a.shape
    dev = a.device
    # b reversed and padded by L on both sides: on diagonal d, row i in
    # 1..L compares a[i - 1] with b[d - 1 - i], one contiguous slice.
    brev_ext = torch.cat([torch.full((pairs, width), -1, dtype=b.dtype, device=dev),
                          torch.flip(b, dims=[1]),
                          torch.full((pairs, width), -1, dtype=b.dtype, device=dev)], dim=1)
    target = (la + lb).cpu()
    order = torch.argsort(target)
    counts = torch.bincount(target, minlength=2 * width + 1).tolist()
    starts = np.concatenate([[0], np.cumsum(counts)])
    order = order.to(dev)
    out = torch.zeros(pairs, dtype=torch.int16, device=dev)
    prev2 = torch.zeros((pairs, width + 1), dtype=torch.int16, device=dev)
    prev = torch.zeros((pairs, width + 1), dtype=torch.int16, device=dev)
    cur = torch.empty_like(prev)
    for d in range(1, 2 * width + 1):
        # D[i-1][j-1] + cost; D[i-1][j] + 1 and D[i][j-1] + 1
        subst = prev2[:, :width] + (a != brev_ext[:, 2 * width - d + 1: 3 * width - d + 1])
        torch.minimum(prev[:, :width], prev[:, 1:], out=cur[:, 1:])
        cur[:, 1:] += 1
        torch.minimum(cur[:, 1:], subst, out=cur[:, 1:])
        cur[:, 0] = d  # D[0][d]
        if d <= width:
            cur[:, d] = d  # D[d][0]
        sel = order[starts[d]: starts[d + 1]]
        if sel.numel():
            out[sel] = cur[sel, la[sel]]
        prev2, prev, cur = prev, cur, prev2
    return out


def lev_matrix(words: List[str], device: DeviceLike = None) -> np.ndarray:
    """Pairwise Levenshtein distance matrix (uint8, clipped at 255) over the
    words' UTF-8 bytes, computed on ``device`` (the card by default)."""
    dev = resolve(device)
    n = len(words)
    out = np.zeros((n, n), dtype=np.uint8)
    if n == 0:
        return out
    codes_np, lengths_np = _encode(words)
    codes = torch.from_numpy(codes_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    per_block = PAIRS_PER_BLOCK if dev.type == "cuda" else CPU_PAIRS_PER_BLOCK
    rows_per_block = max(1, per_block // n)
    for r0 in range(0, n, rows_per_block):
        r1 = min(n, r0 + rows_per_block)
        ri = torch.arange(r0, r1, device=dev).repeat_interleave(n)
        ci = torch.arange(n, device=dev).repeat(r1 - r0)
        dist = _pair_distances(codes[ri], lengths[ri], codes[ci], lengths[ci])
        # a pair of two empty words ends on diagonal 0, which is not swept
        out[r0:r1] = dist.clamp(max=255).to(torch.uint8).view(r1 - r0, n).cpu().numpy()
    np.fill_diagonal(out, 0)
    return out


def levenshtein(a: str, b: str) -> int:
    """Levenshtein distance between the UTF-8 bytes of two strings (host)."""
    ea, eb = a.encode("utf-8"), b.encode("utf-8")
    if len(ea) < len(eb):
        ea, eb = eb, ea
    prev = list(range(len(eb) + 1))
    for i, ca in enumerate(ea, 1):
        cur = [i]
        for j, cb in enumerate(eb, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]
