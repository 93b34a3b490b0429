"""Tiny shared formatters for debug/RPC dumps."""

from __future__ import annotations


def bits_str(b) -> str | None:
    """Bool list -> compact bit-array string ('x_x_'), None passthrough —
    the reference BitArray rendering used by dump_consensus_state."""
    if b is None:
        return None
    return "".join("x" if v else "_" for v in b)
