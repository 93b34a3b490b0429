"""Consensus write-ahead log: every input persisted before it acts.

Reference: `consensus/wal.go` — timestamped records of round-state events,
peer messages, and timeouts, fsync'd per write (`Save` `:73-94`);
`#ENDHEIGHT: n` markers delimit heights (`:97-103`) so recovery knows
where to resume; `light` mode skips block parts (`:80-87`).

Records here are length-prefixed binary: u32(len) || u8(kind) || payload,
with a CRC32 per record so a torn tail write is detected and truncated on
replay rather than crashing recovery.

Copy of `tendermint_tpu/consensus/wal.py` with its `wal.write` spans: the
same frames byte for byte, so either package reads the other's files.
"""

from __future__ import annotations

import os
import struct
import zlib

from tendermint_tpu_torch.utils import tracing
from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("wal")

# record kinds
REC_ENDHEIGHT = 0x01
REC_MESSAGE = 0x02       # payload: consensus message (msgs.encode_msg)
REC_TIMEOUT = 0x03       # payload: TimeoutInfo

# resync bound: a frame claiming more than this is treated as garbage,
# not as a real record we should wait 64MB of scanning to disprove
MAX_RECORD_BYTES = 64 << 20


class WAL:
    def __init__(self, path: str, light: bool = False):
        self.path = path
        self.light = light
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "ab")

    # -- writing ---------------------------------------------------------
    def _write(self, kind: int, payload: bytes) -> None:
        body = struct.pack(">B", kind) + payload
        crc = zlib.crc32(body) & 0xFFFFFFFF
        self._f.write(struct.pack(">II", len(body), crc) + body)

    def save_message(self, payload: bytes) -> None:
        with tracing.span("wal.write", cat=tracing.CAT_NONE,
                          kind="message", bytes=len(payload)):
            self._write(REC_MESSAGE, payload)
            self._sync()

    def save_timeout(self, height: int, round_: int, step: int) -> None:
        with tracing.span("wal.write", cat=tracing.CAT_NONE,
                          kind="timeout", height=height):
            self._write(REC_TIMEOUT,
                        struct.pack(">QIB", height, round_, step))
            self._sync()

    def write_end_height(self, height: int) -> None:
        """Reference `:97-103`: marks height as irreversibly committed."""
        with tracing.span("wal.write", cat=tracing.CAT_NONE,
                          kind="end_height", height=height):
            self._write(REC_ENDHEIGHT, struct.pack(">Q", height))
            self._sync()

    def _sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()

    # -- reading ---------------------------------------------------------
    @staticmethod
    def _frame_at(data: bytes, pos: int) -> tuple[int, bytes] | None:
        """Decode one valid `len||crc||body` frame at `pos`, else None."""
        if pos + 8 > len(data):
            return None
        ln, crc = struct.unpack_from(">II", data, pos)
        if ln < 1 or ln > MAX_RECORD_BYTES or pos + 8 + ln > len(data):
            return None
        body = data[pos + 8:pos + 8 + ln]
        if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            return None
        return ln, body

    @staticmethod
    def read_all(path: str) -> list[tuple[int, bytes]]:
        """All (kind, payload) records.  A corrupt mid-file frame (bit
        rot, partial overwrite) is skipped by scanning forward for the
        next offset that decodes as a valid frame — one bad record must
        not discard every good record written after it.  A torn tail
        (no further valid frame) still truncates cleanly."""
        out = []
        if not os.path.exists(path):
            return out
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 8 <= len(data):
            frame = WAL._frame_at(data, pos)
            if frame is None:
                resync = WAL._scan_forward(data, pos + 1)
                if resync is None:
                    break            # torn/corrupt tail: nothing left
                log.warn("wal: skipped corrupt region; resynced",
                         path=path, offset=pos, skipped=resync - pos)
                pos = resync
                continue
            ln, body = frame
            out.append((body[0], body[1:]))
            pos += 8 + ln
        return out

    @staticmethod
    def _scan_forward(data: bytes, start: int) -> int | None:
        """First offset >= start where a valid frame decodes, else None.
        A stray 9-byte match is a ~1-in-4-billion CRC coincidence —
        acceptable odds for salvaging a crashed validator's log."""
        for pos in range(start, len(data) - 8):
            if WAL._frame_at(data, pos) is not None:
                return pos
        return None

    @staticmethod
    def fsck(path: str, repair: bool = False) -> dict:
        """Report (and optionally repair) WAL corruption.  Returns
        {records, end_heights, bad_regions: [(offset, skipped)],
        tail_garbage, repaired}.  Repair rewrites the file atomically
        with only the valid records, preserving their order."""
        report = {"records": 0, "end_heights": [], "bad_regions": [],
                  "tail_garbage": 0, "repaired": False}
        if not os.path.exists(path):
            return report
        with open(path, "rb") as f:
            data = f.read()
        good: list[bytes] = []
        pos = 0
        while pos + 8 <= len(data):
            frame = WAL._frame_at(data, pos)
            if frame is None:
                resync = WAL._scan_forward(data, pos + 1)
                if resync is None:
                    report["tail_garbage"] = len(data) - pos
                    pos = len(data)
                    break
                report["bad_regions"].append((pos, resync - pos))
                pos = resync
                continue
            ln, body = frame
            good.append(data[pos:pos + 8 + ln])
            report["records"] += 1
            if body[0] == REC_ENDHEIGHT and ln == 9:
                report["end_heights"].append(
                    struct.unpack(">Q", body[1:])[0])
            pos += 8 + ln
        if pos < len(data):
            report["tail_garbage"] = len(data) - pos
        if repair and (report["bad_regions"] or report["tail_garbage"]):
            tmp = path + ".fsck"
            with open(tmp, "wb") as f:
                f.write(b"".join(good))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            report["repaired"] = True
        return report

    @staticmethod
    def records_since_height(path: str, height: int) -> list | None:
        """Records after `#ENDHEIGHT height-1` for catchup replay
        (reference `consensus/replay.go:111-169` semantics: returns None if
        an ENDHEIGHT for `height` itself exists — nothing to replay — and
        [] if the marker for height-1 is missing entirely)."""
        recs = WAL.read_all(path)
        # a marker for `height` means that height fully committed
        start = None
        for i, (kind, payload) in enumerate(recs):
            if kind == REC_ENDHEIGHT:
                h = struct.unpack(">Q", payload)[0]
                if h >= height:
                    return None
                if h == height - 1:
                    start = i + 1
        if start is None:
            return []
        return recs[start:]
