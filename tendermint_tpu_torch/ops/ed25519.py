"""Batched ed25519 — the crypto hot plane of the port, with the wrappers
of kernels K1-K3 and K5 beside their plain twins.

Twin of `tendermint_tpu/ops/ed25519.py`'s entry points:

* `build_neg_comb` (K2, `csrc/build_neg_comb.cu`): per-validator-set comb
  tables of the NEGATED keys, uint8[26, 1024, V, 3, 32] + ok[V];
* `verify_grouped` / `verify_grouped_templated` (K1,
  `csrc/verify_grouped.cu`): cofactorless verify enc([s]B + [k](-A)) == R
  with k = SHA-512(R || A || M) mod L, s < L, masked by pub_ok[val_idx];
* `sign_grouped_templated` (K3, `csrc/sign_grouped.cu`): RFC 8032 signing;
* `verify_batch` (K5, `csrc/verify_raw.cu`): raw lanes, each with its own
  key: decompress A and R, [s]B + [k](-A) by a 4-bit-window ladder, and a
  projective comparison with R, masked by both decompressions and s < L;
* `verify_tally` (K6, `csrc/verify_tally.cu`): K5's lanes over a grid of
  rows, with each row's int64 voting-power tally of its valid lanes and
  its quorum check (`parallel/sharding.py`'s verify and tally).

Each wrapper validates its arguments and, on CUDA tensors, launches its
kernel (or raises); on CPU tensors it runs the plain twin, which follows
the reference's algorithm step by step in PyTorch.  The plain twins also
run on CUDA tensors when called directly — that is how the kernels are
held against them on the card.

Indices out of range, one rule for K1, K3 and their plain twins: a lane
whose `val_idx`, key row or `tmpl_idx` is < 0 or >= its count verifies
False (K1) or signs 64 zero bytes (K3).  The plain twins compute such a
lane on clamped indices and mask it; neither route wraps or raises.  (The
JAX package's `jnp.take` wraps -1 and fills past the end, depending on
the jax version: a deliberate difference.  `CudaBackend` rejects such
indices before any launch.)
"""

from __future__ import annotations

import torch

from tendermint_tpu_torch.ops import curve, kernels
from tendermint_tpu_torch.ops import scalar as sc
from tendermint_tpu_torch.ops import sha512 as s512

U8, I32 = torch.uint8, torch.int32


def base_table(device) -> torch.Tensor:
    """The 12-bit fixed-base comb table uint8[22, 4096, 3, 32] on `device`."""
    return torch.as_tensor(curve._base_table(), device=device)


# -- plain twins ---------------------------------------------------------

def build_neg_comb_plain(pubkeys: torch.Tensor) -> tuple:
    """Decompress V pubkeys and build comb tables of their negations
    (reference `ed25519.build_neg_comb`)."""
    A, ok = curve.decompress(pubkeys)
    tbl, tbl_ok = curve.build_affine_comb(curve.pt_neg(A))
    return tbl, ok & tbl_ok


def verify_core(pubkeys, sigs, k_scalars, base_tbl) -> torch.Tensor:
    """Verify with a precomputed challenge k = H(R || A || M) mod L
    (reference `ed25519.verify_core`) -> bool[...]."""
    A, ok_a = curve.decompress(pubkeys)
    R, ok_r = curve.decompress(sigs[..., :32])
    s_bytes = sigs[..., 32:]
    ok_s = sc.lt_L(s_bytes)
    sB = curve.scalar_mul_base(s_bytes, base_tbl)
    kA = curve.scalar_mul(k_scalars, curve.pt_neg(A))
    return ok_a & ok_r & ok_s & curve.pt_eq(curve.pt_add(sB, kA), R)


def verify_batch_plain(pubkeys, msgs, sigs, base_tbl) -> torch.Tensor:
    """Reference `ed25519.verify`: k = SHA-512(R || A || M) mod L, then
    `verify_core`."""
    challenge = torch.cat([sigs[..., :32], pubkeys, msgs], dim=-1)
    k = sc.reduce512(s512.sha512(challenge))
    return verify_core(pubkeys, sigs, k, base_tbl)


def verify_tally_plain(pubkeys, msgs, sigs, powers, rows, total_power,
                       base_tbl) -> tuple:
    """`verify_batch_plain` over `rows` rows of N / rows lanes, then per
    row, in int64: tallied = the powers of the valid lanes summed, and
    block_ok = every lane valid or of power 0, and tallied * 3 >
    total_power * 2 (reference `sharding.training_step_fn`'s step, whose
    int32 sums the port does not copy) -> (ok[N], tallied[rows],
    block_ok[rows])."""
    return tally_plain(verify_batch_plain(pubkeys, msgs, sigs, base_tbl),
                       powers, rows, total_power)


def tally_plain(ok, powers, rows, total_power) -> tuple:
    """`verify_tally_plain`'s step after the verify, on its mask `ok`."""
    shape = (rows, ok.shape[0] // rows)
    grid_ok, grid_pw = ok.view(shape), powers.view(shape)
    tallied = torch.where(grid_ok, grid_pw, 0).sum(-1, dtype=torch.int64)
    sig_ok = (grid_ok | (grid_pw == 0)).all(-1)
    total = torch.tensor(int(total_power), dtype=torch.int64)
    return ok, tallied, sig_ok & (tallied * 3 > total * 2)


def _clamped(idx: torch.Tensor, count: int) -> tuple:
    """(idx clamped into [0, count) as int64, lanes whose idx was in
    range): the module's rule for indices out of range."""
    inside = (idx >= 0) & (idx < count)
    return idx.long().clamp(0, max(count - 1, 0)), inside


def verify_grouped_plain(tables, pub_ok, val_idx, pubkeys, msgs, sigs,
                         base_tbl) -> torch.Tensor:
    """Reference `ed25519.verify_grouped`, step by step; a lane whose
    val_idx is out of range verifies False."""
    vi, inside = _clamped(val_idx, tables.shape[2])
    if not tables.shape[2]:
        return inside                   # no lane is in range
    challenge = torch.cat([sigs[..., :32], pubkeys, msgs], dim=-1)
    k = sc.reduce512(s512.sha512(challenge))
    s_bytes = sigs[..., 32:]
    ok_s = sc.lt_L(s_bytes)
    sB = curve.scalar_mul_base(s_bytes, base_tbl)
    kA = curve.scalar_mul_comb(tables, vi, k)
    enc, ok_z = curve.encode_batch(curve.pt_add(sB, kA))
    ok_r = (enc == sigs[..., :32]).all(dim=-1)
    return inside & pub_ok[vi] & ok_s & ok_r & ok_z


def verify_grouped_templated_plain(tables, pub_ok, val_pubs, val_idx,
                                   tmpl_idx, templates, sigs,
                                   base_tbl) -> torch.Tensor:
    """Reference `ed25519.verify_grouped_templated`: gather each lane's
    template and pubkey, then `verify_grouped_plain`; a lane whose
    val_idx or tmpl_idx is out of range verifies False."""
    vi, v_in = _clamped(val_idx, val_pubs.shape[0])
    ti, t_in = _clamped(tmpl_idx, templates.shape[0])
    if not (val_pubs.shape[0] and templates.shape[0]):
        return v_in & t_in              # no lane is in range
    return t_in & verify_grouped_plain(tables, pub_ok, val_idx, val_pubs[vi],
                                       templates[ti], sigs, base_tbl)


def sign_grouped_templated_plain(a_scalars, prefixes, pubkeys, val_idx,
                                 tmpl_idx, templates,
                                 base_tbl) -> torch.Tensor:
    """Reference `ed25519.sign_grouped_templated`: r = H(prefix || M),
    R = [r]B, k = H(R || A || M), S = (r + k*a) mod L; a lane whose
    val_idx or tmpl_idx is out of range signs 64 zero bytes."""
    vi, v_in = _clamped(val_idx, a_scalars.shape[0])
    ti, t_in = _clamped(tmpl_idx, templates.shape[0])
    inside = v_in & t_in
    if not (a_scalars.shape[0] and templates.shape[0]):
        return torch.zeros((len(val_idx), 64), dtype=U8,
                           device=val_idx.device)   # no lane is in range
    msgs = templates[ti]
    r = sc.reduce512(s512.sha512(torch.cat([prefixes[vi], msgs], dim=-1)))
    R_bytes, _ = curve.encode_batch(curve.scalar_mul_base(r, base_tbl))
    k = sc.reduce512(s512.sha512(
        torch.cat([R_bytes, pubkeys[vi], msgs], dim=-1)))
    s = sc.muladd_mod_L(k, a_scalars[vi], r)
    sigs = torch.cat([R_bytes, s.to(U8)], dim=-1)
    return torch.where(inside[:, None], sigs, 0).to(U8)


# -- wrappers ------------------------------------------------------------

def _check_base(base_tbl):
    kernels.check(base_tbl, "base_tbl", U8, 4)
    if tuple(base_tbl.shape) != (curve.BASE_WINDOWS, 1 << curve.BASE_WBITS,
                                 3, 32):
        raise ValueError(f"base_tbl: bad shape {tuple(base_tbl.shape)}")


def _check_tables(tables, pub_ok):
    kernels.check(tables, "tables", U8, 5)
    kernels.check(pub_ok, "pub_ok", torch.bool, 1)
    vb = tables.shape[2]
    if (tuple(tables.shape) != (curve.COMB_WINDOWS, curve.COMB_DIGITS, vb,
                                3, 32) or pub_ok.shape[0] != vb):
        raise ValueError(f"tables {tuple(tables.shape)} / pub_ok "
                         f"{tuple(pub_ok.shape)} do not match")
    return vb


def _check_lanes(val_idx, sigs, *more_idx):
    kernels.check(sigs, "sigs", U8, 2)
    n = sigs.shape[0]
    if sigs.shape[1] != 64:
        raise ValueError("sigs: expected [N, 64]")
    for name, t in (("val_idx", val_idx),) + more_idx:
        kernels.check(t, name, I32, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name}: {t.shape[0]} lanes, sigs has {n}")
    return n


def build_neg_comb(pubkeys: torch.Tensor) -> tuple:
    """pubkeys uint8[V, 32] -> (tables uint8[26, 1024, V, 3, 32], ok bool[V]).
    K2 on a CUDA tensor; the plain twin on a CPU tensor."""
    kernels.check(pubkeys, "pubkeys", U8, 2)
    if pubkeys.shape[1] != 32:
        raise ValueError("pubkeys: expected [V, 32]")
    if pubkeys.device.type == "cpu":
        return build_neg_comb_plain(pubkeys)
    v = pubkeys.shape[0]
    dev = pubkeys.device
    tbl = torch.empty((curve.COMB_WINDOWS, curve.COMB_DIGITS, v, 3, 32),
                      dtype=U8, device=dev)
    ok = torch.empty(v, dtype=I32, device=dev)
    bases = torch.empty((curve.COMB_WINDOWS, v, 4, 10), dtype=I32,
                        device=dev)
    if v:
        kernels.launch("build_neg_comb", pubkeys, v, tbl, ok, bases)
    return tbl, ok != 0


def _check_aligned(**tensors) -> None:
    """K1 and K3 gather 96-byte table entries in 16-byte loads."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must start 16-byte aligned")


def _launch_verify(tables, pub_ok, pubs, pub_idx, val_idx, templates,
                   tmpl_idx, sigs, base_tbl) -> torch.Tensor:
    _check_aligned(tables=tables, base_tbl=base_tbl)
    n = sigs.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=sigs.device)
    if n:
        kernels.launch("verify_grouped", tables, tables.shape[2], pub_ok,
                       pubs, pubs.shape[0], pub_idx, val_idx, templates,
                       templates.shape[0], templates.shape[1], tmpl_idx, sigs,
                       base_tbl, out, n)
    return out


def verify_grouped(tables, pub_ok, val_idx, pubkeys, msgs, sigs,
                   base_tbl) -> torch.Tensor:
    """Lane i checks sigs[i] on msgs[i] by key pubkeys[i], whose negated
    comb table is tables[:, :, val_idx[i]] -> bool[N]; a lane whose
    val_idx is out of range is False.  K1 on CUDA tensors; the plain twin
    on CPU tensors."""
    _check_tables(tables, pub_ok)
    _check_base(base_tbl)
    n = _check_lanes(val_idx, sigs)
    kernels.check(pubkeys, "pubkeys", U8, 2)
    kernels.check(msgs, "msgs", U8, 2)
    if pubkeys.shape != (n, 32) or msgs.shape[0] != n:
        raise ValueError("pubkeys/msgs: expected one row per lane")
    if sigs.device.type == "cpu":
        return verify_grouped_plain(tables, pub_ok, val_idx, pubkeys, msgs,
                                    sigs, base_tbl)
    lanes = torch.arange(n, dtype=I32, device=sigs.device)
    return _launch_verify(tables, pub_ok, pubkeys, lanes, val_idx, msgs,
                          lanes, sigs, base_tbl)


def verify_batch(pubkeys, msgs, sigs, base_tbl) -> torch.Tensor:
    """Lane i checks sigs[i] on msgs[i] by its own key pubkeys[i] ->
    bool[N].  K5 on CUDA tensors; the plain twin on CPU tensors."""
    _check_base(base_tbl)
    kernels.check(sigs, "sigs", U8, 2)
    kernels.check(pubkeys, "pubkeys", U8, 2)
    kernels.check(msgs, "msgs", U8, 2)
    n = sigs.shape[0]
    if sigs.shape[1] != 64 or pubkeys.shape != (n, 32) or msgs.shape[0] != n:
        raise ValueError("verify_batch: expected pubkeys [N, 32], msgs "
                         "[N, M], sigs [N, 64]")
    if sigs.device.type == "cpu":
        return verify_batch_plain(pubkeys, msgs, sigs, base_tbl)
    out = torch.empty(n, dtype=torch.bool, device=sigs.device)
    if n:
        kernels.launch("verify_raw", pubkeys, msgs, msgs.shape[1], sigs,
                       base_tbl, out, n)
    return out


MAX_TALLY_ROWS = 65535          # the grid's y dimension


def verify_tally(pubkeys, msgs, sigs, powers, rows, total_power,
                 base_tbl) -> tuple:
    """Lane i checks sigs[i] on msgs[i] by pubkeys[i] (as `verify_batch`),
    over `rows` rows of N / rows lanes; each row's int64 `powers` of its
    valid lanes are summed and its quorum checked against `total_power` ->
    (ok bool[N], tallied int64[rows], block_ok bool[rows]).  K6 on CUDA
    tensors; the plain twin on CPU tensors."""
    _check_base(base_tbl)
    kernels.check(sigs, "sigs", U8, 2)
    kernels.check(pubkeys, "pubkeys", U8, 2)
    kernels.check(msgs, "msgs", U8, 2)
    kernels.check(powers, "powers", torch.int64, 1)
    n = sigs.shape[0]
    if sigs.shape[1] != 64 or pubkeys.shape != (n, 32) or \
            msgs.shape[0] != n or powers.shape[0] != n:
        raise ValueError("verify_tally: expected pubkeys [N, 32], msgs "
                         "[N, M], sigs [N, 64], powers [N]")
    if not 0 < rows <= MAX_TALLY_ROWS or n % rows:
        raise ValueError(f"verify_tally: {n} lanes do not split into "
                         f"{rows} rows (1 to {MAX_TALLY_ROWS})")
    if sigs.device.type == "cpu":
        return verify_tally_plain(pubkeys, msgs, sigs, powers, rows,
                                  total_power, base_tbl)
    dev = sigs.device
    total = torch.tensor([int(total_power)], dtype=torch.int64, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    tallied = torch.zeros(rows, dtype=torch.int64, device=dev)
    counts = torch.zeros((2, rows), dtype=I32, device=dev)  # bad, done
    block_ok = torch.empty(rows, dtype=torch.bool, device=dev)
    kernels.launch("verify_tally", pubkeys, msgs, msgs.shape[1], sigs,
                   powers, base_tbl, total, rows, n // rows, ok, tallied,
                   counts[0], counts[1], block_ok)
    return ok, tallied, block_ok


def verify_grouped_templated(tables, pub_ok, val_pubs, val_idx, tmpl_idx,
                             templates, sigs, base_tbl) -> torch.Tensor:
    """Grouped verify with each lane's message templates[tmpl_idx[i]] and
    key val_pubs[val_idx[i]] gathered on the device -> bool[N]; a lane
    whose val_idx or tmpl_idx is out of range is False.  K1 on CUDA
    tensors; the plain twin on CPU tensors."""
    vb = _check_tables(tables, pub_ok)
    _check_base(base_tbl)
    _check_lanes(val_idx, sigs, ("tmpl_idx", tmpl_idx))
    kernels.check(val_pubs, "val_pubs", U8, 2)
    kernels.check(templates, "templates", U8, 2)
    if tuple(val_pubs.shape) != (vb, 32):
        raise ValueError("val_pubs: expected [Vb, 32]")
    if sigs.device.type == "cpu":
        return verify_grouped_templated_plain(tables, pub_ok, val_pubs,
                                              val_idx, tmpl_idx, templates,
                                              sigs, base_tbl)
    return _launch_verify(tables, pub_ok, val_pubs, val_idx, val_idx,
                          templates, tmpl_idx, sigs, base_tbl)


def sign_grouped_templated(a_scalars, prefixes, pubkeys, val_idx, tmpl_idx,
                           templates, base_tbl) -> torch.Tensor:
    """Lane i signs templates[tmpl_idx[i]] with key val_idx[i] (clamped
    scalar a, prefix and pubkey rows uint8[V, 32]) -> sigs uint8[N, 64];
    a lane whose val_idx or tmpl_idx is out of range gets 64 zero bytes.
    K3 on CUDA tensors; the plain twin on CPU tensors."""
    _check_base(base_tbl)
    for name, t in (("a_scalars", a_scalars), ("prefixes", prefixes),
                    ("pubkeys", pubkeys)):
        kernels.check(t, name, U8, 2)
        if t.shape != a_scalars.shape or t.shape[1] != 32:
            raise ValueError(f"{name}: expected [V, 32] like a_scalars")
    kernels.check(val_idx, "val_idx", I32, 1)
    kernels.check(tmpl_idx, "tmpl_idx", I32, 1)
    kernels.check(templates, "templates", U8, 2)
    n = val_idx.shape[0]
    if tmpl_idx.shape[0] != n:
        raise ValueError("val_idx/tmpl_idx: lane counts differ")
    if val_idx.device.type == "cpu":
        return sign_grouped_templated_plain(a_scalars, prefixes, pubkeys,
                                            val_idx, tmpl_idx, templates,
                                            base_tbl)
    _check_aligned(base_tbl=base_tbl)
    out = torch.empty((n, 64), dtype=U8, device=val_idx.device)
    if n:
        kernels.launch("sign_grouped", a_scalars, prefixes, pubkeys,
                       pubkeys.shape[0], val_idx, tmpl_idx, templates,
                       templates.shape[0], templates.shape[1], base_tbl, out,
                       n)
    return out
