"""Reader for MMseqs2-style flat DBs (interop with the reference tool).

A DB is a data file (or numbered per-thread files .0, .1, ...) of
NUL-terminated entries plus an .index of "key \t offset \t length" lines
(DBReader.h:58-62). Offsets are global across the numbered files
concatenated in order. Entry length includes the trailing "\n\0".

This lets users bring DBs produced by the reference (or feed our outputs
into its tooling) and lets tests diff our stage outputs against oracle
intermediates.
"""

from __future__ import annotations

from pathlib import Path


class FlatDB:
    def __init__(self, data: bytes, index: list[tuple[int, int, int]],
                 compressed: bool = False):
        self._data = data
        self.index = index
        self._by_key = {k: (o, l) for k, o, l in index}
        self.compressed = compressed

    @classmethod
    def open(cls, base: str | Path) -> "FlatDB":
        base = Path(base)
        if base.exists() and not base.is_dir():
            data = base.read_bytes()
        else:
            parts = []
            i = 0
            while (p := base.parent / f"{base.name}.{i}").exists():
                parts.append(p.read_bytes())
                i += 1
            if not parts:
                raise FileNotFoundError(base)
            data = b"".join(parts)
        index = []
        with open(f"{base}.index") as fh:
            for line in fh:
                k, o, l = line.split("\t")
                index.append((int(k), int(o), int(l)))
        # per-entry zstd compression flag: dbtype bit 31
        # (DBReader::isCompressed, DBReader.cpp:1044-1046)
        compressed = False
        dbt = Path(f"{base}.dbtype")
        if dbt.exists():
            raw = dbt.read_bytes()
            if len(raw) >= 4:
                import struct
                compressed = bool(struct.unpack("<I", raw[:4])[0] & (1 << 31))
        return cls(data, index, compressed=compressed)

    def _decompress(self, offset: int) -> bytes:
        """One compressed entry at file offset: [u32 stored size][zstd
        frame OR raw payload][flag byte: NUL = compressed, 0xFF = raw]
        (DBWriter::writeEnd, DBWriter.cpp:331-399; the INDEX length
        records the ORIGINAL size, so spans derive from the stored u32,
        DBReader::getDataCompressed, DBReader.cpp:560-585)."""
        import struct
        c_size = struct.unpack("<I", self._data[offset:offset + 4])[0]
        payload = self._data[offset + 4:offset + 4 + c_size]
        flag = self._data[offset + 4 + c_size]
        if flag == 0:
            import zstandard
            out = zstandard.ZstdDecompressor().decompress(
                payload, max_output_size=1 << 31)
        else:
            out = payload
        # the reference only NUL-terminates the decompressed payload
        # (DBReader::getDataCompressed); appending a newline here would
        # inject a spurious 0x0A into binary entries (e.g. profiles)
        return out + b"\x00"

    @property
    def size(self) -> int:
        return len(self.index)

    def keys(self) -> list[int]:
        return [k for k, _, _ in self.index]

    def _entry(self, o: int, l: int) -> bytes:
        if self.compressed:
            return self._decompress(o)
        return self._data[o:o + l]

    def get(self, key: int) -> str:
        o, l = self._by_key[key]
        return self._entry(o, l).rstrip(b"\x00").decode()

    def get_bytes(self, key: int) -> bytes:
        """Raw entry bytes (for binary payloads like profiles), without
        the trailing NUL terminator."""
        data = self._entry(*self._by_key[key])
        return data[:-1] if data.endswith(b"\x00") else data

    def entries(self):
        for k, o, l in self.index:
            yield k, self._entry(o, l).rstrip(b"\x00").decode()

    def lines(self, key: int) -> list[str]:
        return [ln for ln in self.get(key).split("\n") if ln]


def _compress_entry(payload: bytes) -> bytes:
    """DBWriter::writeData compressed-entry framing
    (commons/DBWriter.cpp:331-399): [u32 stored size][zstd frame OR raw
    payload][flag byte NUL=compressed / 0xFF=raw].  The reference keeps
    the RAW payload when compression does not shrink it."""
    import struct
    try:
        import zstandard
        comp = zstandard.ZstdCompressor(level=3).compress(payload)
    except ImportError:           # environment without zstd: store raw
        comp = None
    if comp is not None and len(comp) < len(payload):
        return struct.pack("<I", len(comp)) + comp + b"\x00"
    return struct.pack("<I", len(payload)) + payload + b"\xff"


def write_flatdb(base: str | Path, entries: list[tuple[int, str]],
                 dbtype: int | None = None,
                 compressed: bool = False) -> None:
    """Write a flat DB (data + .index [+ .dbtype]) the reference's tools
    can read (DBWriter semantics: each entry NUL-terminated, entries
    ending in '\\n' before the NUL; index length includes the NUL,
    commons/DBWriter.cpp).  `compressed=True` writes per-entry zstd
    frames with the DBTYPE_EXTENDED_COMPRESSED bit (bit 31) set in the
    .dbtype, exactly DBReader::isCompressed's contract — the INDEX
    length stays the ORIGINAL entry size (DBReader.cpp:560-585)."""
    base = Path(base)
    with open(base, "wb") as data_fh, open(f"{base}.index", "w") as idx_fh:
        offset = 0
        for key, text in entries:
            if text and not text.endswith("\n"):
                text += "\n"
            blob = text.encode() + b"\x00"
            if compressed:
                stored = _compress_entry(text.encode())
                data_fh.write(stored)
                # index records the ORIGINAL size; spans derive from the
                # stored u32 on read
                idx_fh.write(f"{key}\t{offset}\t{len(blob)}\n")
                offset += len(stored)
            else:
                data_fh.write(blob)
                idx_fh.write(f"{key}\t{offset}\t{len(blob)}\n")
                offset += len(blob)
    if dbtype is not None or compressed:
        import struct
        dt = dbtype if dbtype is not None else 0
        if compressed:
            dt |= 1 << 31
        Path(f"{base}.dbtype").write_bytes(struct.pack("<I", dt & 0xFFFFFFFF))


def write_flatdb_bytes(base: str | Path, entries: list[tuple[int, bytes]],
                       dbtype: int | None = None) -> None:
    """write_flatdb for binary payloads (e.g. profile DBs): entries are
    raw bytes, NUL-terminated like DBWriter's."""
    base = Path(base)
    with open(base, "wb") as data_fh, open(f"{base}.index", "w") as idx_fh:
        offset = 0
        for key, blob in entries:
            blob = blob + b"\x00"
            data_fh.write(blob)
            idx_fh.write(f"{key}\t{offset}\t{len(blob)}\n")
            offset += len(blob)
    if dbtype is not None:
        import struct
        Path(f"{base}.dbtype").write_bytes(struct.pack("<i", dbtype))


def read_lookup(base: str | Path) -> list[tuple[int, str, int]]:
    out = []
    with open(f"{base}.lookup") as fh:
        for line in fh:
            k, name, fileno = line.rstrip("\n").split("\t")
            out.append((int(k), name, int(fileno)))
    return out
