"""K1's roofline count is the kernels line's, and its least time takes
the shortcut only where bytes cannot bound the call."""

import numpy as np
import torch

from bftbench.costs import k1, peaks


def row1_inputs(seed=1):
    """Row 1's shape: 65,536 lanes over 1,024 templates and a key matrix
    of 128 rows (100 keys padded by repeating key 0)."""
    rng = np.random.default_rng(seed)
    pubs = rng.integers(0, 256, (100, 32), dtype=np.uint8)
    pubs = np.concatenate([pubs, np.repeat(pubs[:1], 28, axis=0)])
    n, t = 65536, 1024
    val_idx = np.tile(np.arange(100, dtype=np.int32), n // 100 + 1)[:n]
    tmpl_idx = np.repeat(np.arange(t, dtype=np.int32), n // t)
    templates = rng.integers(0, 256, (t, 128), dtype=np.uint8)
    sigs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    return pubs, val_idx, tmpl_idx, templates, sigs


def test_k1_cost_is_the_kernels_lines_at_row_1():
    import chip_smoke
    pubs, val_idx, tmpl_idx, templates, sigs = row1_inputs()
    args = (None, torch.ones(len(pubs), dtype=torch.uint8),
            torch.from_numpy(pubs), torch.from_numpy(val_idx),
            torch.from_numpy(tmpl_idx), torch.from_numpy(templates),
            torch.from_numpy(sigs))
    want = chip_smoke._templated_cost(args)
    got = k1.templated_cost(pubs, val_idx, tmpl_idx, templates, sigs)
    assert got == want
    assert k1.bound_s(len(sigs), 128, len(templates), len(pubs)) == (
        chip_smoke._bound(*want)[0] / 1e3, "operations")


def test_the_shortcut_gives_the_exact_bound():
    n, t, v = 62_500, 625, 100
    t_ops, by = k1.bound_s(n, 128, t, v, rows=lambda: 1 / 0)
    assert by == "operations"
    assert t_ops == k1.ops(n, 128) / peaks.INT32_OPS_PER_S
    # few lanes over many keys: the most rows could bound, so it counts
    rows = []
    k1.bound_s(4, 10_000, 1, 100_000, rows=lambda: rows.append(1) or 8)
    assert rows == [1]
