"""The work of kernel K1, the grouped comb verify, and its least time.

What a batch of verify lanes needs, whatever the kernel does beyond it.
Per lane: one SHA-512 of R || A || M; [s]B and [k]A as sums over
fixed-base comb tables (12-bit digits of s over 22 windows, 10-bit
digits of k mod L over 26 windows, one mixed add per window onto the
first entry, one multiplication to extend it); one add of the two sums;
the encoding (a batch inversion, x and y).  Bytes: each lane's signature,
key index, template index and result once, the templates, keys and key
flags once, and each distinct table row (96 bytes) the lanes' digits
gather.  32-bit integer operations count a field product at 100
multiply-adds and a square at 55, a SHA-512 block at 3,536 (64-bit
words on 32-bit halves); the mod-L reduction, < 1 % of a lane, is left
out, which can only lower the bound.  The same counts as the kernels
line of `chip_smoke.py` (`_grouped_verify_cost`, `_templated_cost`,
`_bound`).
"""

from __future__ import annotations

import hashlib

import numpy as np

from bftbench.costs import peaks
from bftbench.reference.ed25519 import L

KERNEL = "verify_grouped_kernel"     # its name in the profiler's trace
MACS_MUL, MACS_SQR = 100, 55
MIXED_ADD = (7, 0)      # extended + cached affine (y+x, y-x, 2dxy)
ADD = (9, 0)            # extended + extended
INVERT = (11, 254)      # z^(p-2)
BATCH_INV = (3, 0)      # per point, beside one INVERT per call
SHA512_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 16
K_WINDOWS, K_WIDTH = 26, 10        # digits of k mod L
S_WINDOWS, S_WIDTH = 22, 12        # digits of s
ROW_BYTES = 96
LANE_BYTES = 64 + 4 + 4 + 1        # signature, key and template index, result


def _macs(*terms) -> int:
    return sum(n * (m * MACS_MUL + q * MACS_SQR) for n, (m, q) in terms)


def ops(n: int, msg_len: int) -> int:
    """32-bit integer operations of `n` lanes of `msg_len`-byte messages."""
    blocks = (64 + msg_len + 17 + 127) // 128
    return (n * blocks * SHA512_OPS_PER_BLOCK
            + _macs((n * 46, MIXED_ADD), (n * 2, (1, 0)), (n, ADD),
                    (n, BATCH_INV), (n * 2, (1, 0)), (1, INVERT)))


def _le_digits(rows, width: int, windows: int) -> np.ndarray:
    """Little-endian `width`-bit digits of the integers in uint8[N, B]
    rows -> int64[N, windows]."""
    rows = np.ascontiguousarray(rows, np.uint8)
    nbits = width * windows
    weights = np.left_shift(1, np.arange(width, dtype=np.int64))
    out = np.zeros((len(rows), windows), np.int64)
    for lo in range(0, len(rows), 65536):
        bits = np.unpackbits(rows[lo:lo + 65536], axis=1, bitorder="little")
        if bits.shape[1] < nbits:
            bits = np.pad(bits, ((0, 0), (0, nbits - bits.shape[1])))
        out[lo:lo + 65536] = bits[:, :nbits].reshape(
            -1, windows, width).astype(np.int64) @ weights
    return out


def _distinct_rows(digits, extra=None) -> int:
    """Distinct (window, digit[, key]) table rows a batch gathers."""
    n, windows = digits.shape
    packed = (np.arange(windows, dtype=np.int64)[None, :] << 40) | (
        digits.astype(np.int64) << 20)
    if extra is not None:
        packed |= np.asarray(extra, np.int64)[:, None]
    return len(np.unique(packed))


def table_rows(sigs, lane_pubs, lane_msgs, val_idx) -> int:
    """Distinct comb-table rows the lanes gather: their s digits from the
    base table, their k digits from their key's table."""
    n = len(sigs)
    k = b"".join((int.from_bytes(hashlib.sha512(
        sigs[i, :32].tobytes() + lane_pubs[i].tobytes()
        + lane_msgs[i].tobytes()).digest(), "little") % L).to_bytes(
        32, "little") for i in range(n))
    kd = _le_digits(np.frombuffer(k, np.uint8).reshape(-1, 32), K_WIDTH,
                    K_WINDOWS)
    sd = _le_digits(sigs[:, 32:], S_WIDTH, S_WINDOWS)
    return _distinct_rows(sd) + _distinct_rows(kd, val_idx)


def cost(sigs, lane_pubs, lane_msgs, val_idx, lane_bytes: int,
         fixed_bytes: int) -> tuple:
    """(bytes, operations) of a grouped verify over these lanes."""
    n, m = lane_msgs.shape
    nbytes = n * lane_bytes + fixed_bytes + ROW_BYTES * table_rows(
        sigs, lane_pubs, lane_msgs, val_idx)
    return nbytes, ops(n, m)


def templated_cost(pubs, val_idx, tmpl_idx, templates, sigs) -> tuple:
    """(bytes, operations) of templated K1: lanes (val_idx, tmpl_idx,
    sig) over `templates` and the key matrix `pubs`."""
    return cost(sigs, pubs[val_idx], templates[tmpl_idx], val_idx,
                LANE_BYTES, templates.nbytes + pubs.nbytes + len(pubs))


def bound_s(n: int, msg_len: int, n_templates: int, n_keys: int,
            rows=None) -> tuple:
    """(least seconds, "operations" or "bytes") of templated K1 over `n`
    lanes, `n_templates` templates of `msg_len` bytes and `n_keys` keys.
    `rows()` gives the distinct table rows; it is called only when the
    most rows the lanes could gather would let bytes bound the call."""
    t_ops = ops(n, msg_len) / peaks.INT32_OPS_PER_S
    fixed = n_templates * msg_len + n_keys * 33
    most = (min(n * K_WINDOWS, K_WINDOWS * (1 << K_WIDTH) * n_keys)
            + min(n * S_WINDOWS, S_WINDOWS * (1 << S_WIDTH)))
    t_most = (n * LANE_BYTES + fixed + ROW_BYTES * most) / \
        peaks.HBM_BYTES_PER_S
    if t_most <= t_ops:
        return t_ops, "operations"
    t_bytes = (n * LANE_BYTES + fixed + ROW_BYTES * rows()) / \
        peaks.HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
