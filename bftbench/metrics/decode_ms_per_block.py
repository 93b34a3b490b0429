"""Block decode (`types/block.py` `Block.decode_bytes`, and the seen
commits' array form): the harness's span around each pass's decode, per
block decoded, in ms.  Moves `blocks_per_s`."""

UNIT = "ms/block"


def read(ctx):
    blocks = sum(p.decoded for p in ctx.records)
    if not blocks:
        return None
    return sum(p.decode_s for p in ctx.records) / blocks * 1e3
