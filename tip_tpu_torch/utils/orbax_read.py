"""Reading tip_tpu's orbax checkpoints without orbax, tensorstore or JAX.

tip_tpu's ``save_checkpoint`` writes each step as
``<ckpt_dir>/<step>/default/``: ``_METADATA`` (JSON: the tree's leaves and
the storage flags ``use_ocdbt`` and ``use_zarr3``) and one OCDBT key-value
store holding a zarr v2 array per leaf (``<name>/.zarray`` and its chunks
``<name>/0.0``, ``<name>/0``). The reader here has three layers, bottom up:

  zstd   ``zstd_decompress`` through ``ctypes`` on the system's
         ``libzstd.so.1`` (no pure-Python fallback: without the library the
         first decompression raises OSError naming it).
  OCDBT  ``OcdbtStore``: tensorstore's published OCDBT format. The manifest
         (``manifest.ocdbt``, of the kind "single" that orbax writes) holds
         the config, a data file table and the newest versions inline (older
         ones in version-tree nodes, not read); the newest version names the
         root b-tree node by
         (data file, offset, length). Interior nodes hold each child's
         lower-bound key, the length of the prefix its keys share (cut from
         the keys stored below it) and its reference; leaves hold each
         value inline or by reference into a data file. A data file's path
         is its base path plus its relative path under the store's root,
         which is how a merged root store points into
         ``ocdbt.process_<i>/``. Manifests and nodes are encoded files
         (magic, length, format version, compression, body, CRC-32C), all
         checked. Data files are read by offset through ``mmap``.
  zarr   ``read_array``: a v2 ``.zarray`` (``order`` C, compressor zstd or
         none, no filters), its chunk grid with separator ``.``, absent
         chunks taking ``fill_value`` (null reads as zero).

``read_orbax(step_dir)`` returns every stored array by orbax's parameter
name (``params.rnn.w_hh``, ``opt_state.1.0.mu.layers.0.b_q``, ``rng``,
``step``), in the stored dtype and shape. What it does not read raises
ValueError naming the field and its value: ``use_zarr3: true``,
``use_ocdbt: false``, another compressor, filters, ``order`` F.
"""

import ctypes
import functools
import json
import mmap
import os
import struct
from typing import Dict, List, Optional

import numpy as np

LIBZSTD = "libzstd.so.1"
MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_NO_ROOT = 2 ** 64 - 1          # the root offset of an empty tree


# ---------------------------------------------------------------------------
# zstd through ctypes
# ---------------------------------------------------------------------------

class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_CONTENTSIZE_ERROR = 2 ** 64 - 2


@functools.lru_cache(maxsize=None)
def _zstd():
    """The system's zstd library, loaded once, its functions declared."""
    try:
        lib = ctypes.CDLL(LIBZSTD)
    except OSError as e:
        raise OSError(f"cannot load {LIBZSTD} (the system's zstd library, "
                      f"which reading an orbax checkpoint needs): {e}") from e
    sz, vp = ctypes.c_size_t, ctypes.c_void_p
    for name, res, args in (
            ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, sz]),
            ("ZSTD_findFrameCompressedSize", sz, [vp, sz]),
            ("ZSTD_decompress", sz, [vp, sz, vp, sz]),
            ("ZSTD_isError", ctypes.c_uint, [sz]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [sz]),
            ("ZSTD_createDStream", vp, []),
            ("ZSTD_freeDStream", sz, [vp]),
            ("ZSTD_initDStream", sz, [vp]),
            ("ZSTD_DStreamOutSize", sz, []),
            ("ZSTD_decompressStream", sz,
             [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _check(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_decompress(data: bytes) -> bytearray:
    """One zstd frame -> its content. The frame is first measured
    (``ZSTD_findFrameCompressedSize``: a cut frame fails there); one that
    states its size is decompressed in one call, one that does not through
    a stream. Every error raises ValueError with zstd's own name for it."""
    lib = _zstd()
    src = ctypes.create_string_buffer(bytes(data), len(data))
    size = lib.ZSTD_getFrameContentSize(src, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame (ZSTD_getFrameContentSize "
                         "failed)")
    used = _check(lib, lib.ZSTD_findFrameCompressedSize(src, len(data)))
    if used != len(data):
        raise ValueError(f"zstd: {len(data) - used} bytes after the frame")
    if size != _CONTENTSIZE_UNKNOWN:
        out = bytearray(max(size, 1))
        dst = (ctypes.c_char * len(out)).from_buffer(out)
        n = _check(lib, lib.ZSTD_decompress(dst, size, src, len(data)))
        del dst
        if n != size:
            raise ValueError(f"zstd: the frame states {size} bytes and "
                             f"holds {n}")
        return out if size else bytearray()
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("zstd: ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(ds))
        step = lib.ZSTD_DStreamOutSize()
        chunk = ctypes.create_string_buffer(step)
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        out, left = bytearray(), 1
        while True:
            outb = _OutBuffer(ctypes.cast(chunk, ctypes.c_void_p), step, 0)
            left = _check(lib, lib.ZSTD_decompressStream(
                ds, ctypes.byref(outb), ctypes.byref(inb)))
            out += chunk.raw[:outb.pos]
            if left == 0 or (inb.pos == inb.size and outb.pos < step):
                break
        if left != 0:
            raise ValueError("zstd: the frame is truncated (the stream ended "
                             "before the frame did)")
        return out
    finally:
        lib.ZSTD_freeDStream(ds)


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), as an OCDBT encoded file ends with."""
    c, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads the fields of a decoded body in order."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n):
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: ends inside a field (byte "
                             f"{self.pos} of {len(self.data)})")

    def varint(self) -> int:
        v = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def bytes(self, n: int) -> bytes:
        self._need(n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.bytes(n))


def _decode_file(buf: bytes, magic: int, what: str) -> bytes:
    """An OCDBT encoded file -> its body: the magic (uint32 big-endian),
    the file's length (uint64 little-endian), the format version (varint,
    0), the compression (varint: 0 raw, 1 zstd), the body and the CRC-32C
    of all before it (uint32 little-endian)."""
    if len(buf) < 18:
        raise ValueError(f"{what}: {len(buf)} bytes, too short for an "
                         f"OCDBT file")
    got = struct.unpack(">I", buf[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", buf[4:12])[0]
    if length != len(buf):
        raise ValueError(f"{what}: header states {length} bytes, read "
                         f"{len(buf)} (truncated?)")
    crc = struct.unpack("<I", buf[-4:])[0]
    if crc32c(buf[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    c = _Cursor(buf[:-4], what)
    c.pos = 12
    version, comp = c.varint(), c.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, expected 0")
    body = buf[c.pos:-4]
    if comp == 0:
        return bytes(body)
    if comp == 1:
        return bytes(zstd_decompress(body))
    raise ValueError(f"{what}: compression {comp}, expected 0 (raw) or 1 "
                     f"(zstd)")


def _data_file_table(c: _Cursor) -> List[str]:
    """The table's paths (base path + relative path), each the previous
    one's prefix of the given length plus its stored suffix."""
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    c.varints(n)                 # each base path's length
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: data file prefix {prefix[i]} longer "
                             f"than the previous path")
        prev = prev[:prefix[i]] + c.bytes(suffix[i])
        paths.append(prev.decode())
    return paths


def _file_id(c: _Cursor, table: List[str]) -> str:
    i = c.varint()
    if i >= len(table):
        raise ValueError(f"{c.what}: data file {i} outside a table of "
                         f"{len(table)}")
    return table[i]


def _keys(c: _Cursor, n: int, interior: bool):
    """(keys, each child's common-prefix length or None) of a node's n
    entries: each key is the previous one's prefix of the given length plus
    its stored suffix."""
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    common = c.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: key prefix {prefix[i]} longer than "
                             f"the previous key")
        prev = prev[:prefix[i]] + c.bytes(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """An OCDBT key-value store on disk, read-only, at its newest version.
    ``keys()`` lists it in order, ``read(key)`` returns a value's bytes.
    Close it (or use it in a ``with``) to release the data files."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._maps: Dict[str, mmap.mmap] = {}
        self._files = []
        self._index: Dict[bytes, tuple] = {}
        top = self._root_ref()
        if top is not None:
            self._walk(*top, b"")

    # -- files ---------------------------------------------------------------
    def _range(self, rel: str, offset: int, length: int) -> bytes:
        """length bytes at offset of the data file rel (fewer where the
        file ends first: the decoder of what was read then fails)."""
        m = self._maps.get(rel)
        if m is None:
            path = os.path.join(self.root, rel)
            f = open(path, "rb")
            try:
                size = os.fstat(f.fileno()).st_size
                m = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                     if size else b"")
            except BaseException:
                f.close()
                raise
            self._files.append(f)
            self._maps[rel] = m
        return bytes(m[offset:offset + length])

    def close(self):
        for m in self._maps.values():
            if isinstance(m, mmap.mmap):
                m.close()
        for f in self._files:
            f.close()
        self._maps, self._files = {}, []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- manifest ------------------------------------------------------------
    def _root_ref(self):
        """(data file, offset, length, height) of the newest version's root
        node, or None for an empty store."""
        path = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no OCDBT manifest at {path}")
        with open(path, "rb") as f:
            c = _Cursor(_decode_file(f.read(), MANIFEST_MAGIC,
                                     "manifest.ocdbt"), "manifest.ocdbt")
        # the config: uuid, manifest kind, max inline value bytes, max
        # decoded node bytes, version tree arity, compression (+ zstd level)
        c.bytes(16)
        kind = c.varint()
        if kind != 0:
            raise ValueError(f"manifest.ocdbt: manifest_kind {kind} is not "
                             f"read (only 0, single)")
        c.varints(2)
        c.bytes(1)
        comp = c.varint()
        if comp == 1:
            c.bytes(4)
        elif comp != 0:
            raise ValueError(f"manifest.ocdbt: config compression {comp}")
        table = _data_file_table(c)
        # the version tree's newest leaf, inline: its last entry is newest
        n = c.varint()
        if n == 0:
            return None
        gens = c.varints(n)
        heights = c.u8s(n)
        files = [_file_id(c, table) for _ in range(n)]
        offsets, lengths = c.varints(n), c.varints(n)
        num_keys = c.varints(n)
        i = max(range(n), key=gens.__getitem__)
        if offsets[i] == _NO_ROOT or num_keys[i] == 0:
            return None
        return files[i], offsets[i], lengths[i], heights[i]

    # -- b-tree --------------------------------------------------------------
    def _walk(self, rel, offset, length, height, prefix):
        what = f"{rel}@{offset}"
        c = _Cursor(_decode_file(self._range(rel, offset, length),
                                 BTREE_MAGIC, what), what)
        h = c.u8s(1)[0]
        if h != height:
            raise ValueError(f"{what}: node height {h}, its parent says "
                             f"{height}")
        table = _data_file_table(c)
        n = c.varint()
        keys, common = _keys(c, n, interior=h > 0)
        if h > 0:
            files = [_file_id(c, table) for _ in range(n)]
            offsets, lengths = c.varints(n), c.varints(n)
            c.varints(3 * n)     # keys, tree bytes, indirect bytes below
            for k, cp, f, o, ln in zip(keys, common, files, offsets,
                                       lengths):
                self._walk(f, o, ln, h - 1, prefix + k[:cp])
            return
        lengths = c.varints(n)
        kinds = c.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{what}: value kind outside 0 (inline), 1 "
                             f"(indirect)")
        n_ind = sum(kinds)
        files = [_file_id(c, table) for _ in range(n_ind)]
        offsets = iter(c.varints(n_ind))
        files = iter(files)
        for k, kind, ln in zip(keys, kinds, lengths):
            if kind == 0:
                self._index[prefix + k] = (None, c.bytes(ln))
            else:
                self._index[prefix + k] = (next(files), next(offsets), ln)

    def keys(self) -> List[bytes]:
        return sorted(self._index)

    def __contains__(self, key: bytes) -> bool:
        return key in self._index

    def read(self, key: bytes) -> bytes:
        ref = self._index.get(key)
        if ref is None:
            raise KeyError(key)
        if ref[0] is None:
            return ref[1]
        return self._range(*ref)


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------

def _fill(value, dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in named:
            raise ValueError(f"fill_value {value!r} not supported")
        return named[value]
    return value


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of the store, whole."""
    meta = json.loads(store.read(f"{name}/.zarray".encode()))
    where = f"{name}/.zarray"
    for field, ok in (("zarr_format", (2,)), ("order", ("C",)),
                      ("filters", (None, []))):
        if meta.get(field) not in ok:
            raise ValueError(f"{where}: {field} {meta.get(field)!r} is not "
                             f"read (only {ok[0]!r})")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor id {comp.get('id')!r} is not "
                         f"read (only 'zstd' or null)")
    sep = meta.get("dimension_separator", ".")
    if sep != ".":
        raise ValueError(f"{where}: dimension_separator {sep!r} is not read "
                         f"(only '.')")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise ValueError(f"{where}: dtype {meta['dtype']!r} is not "
                         f"read") from e
    if dtype.kind not in "biuf":
        raise ValueError(f"{where}: dtype {meta['dtype']!r} is not read")
    dtype = dtype.newbyteorder("=")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(ch <= 0 for ch in chunks):
        raise ValueError(f"{where}: chunks {list(chunks)} for shape "
                         f"{list(shape)}")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype), dtype)
    grid = [-(-s // ch) for s, ch in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}".encode()
        if key not in store:
            continue                      # absent: the fill value
        raw = store.read(key)
        if comp is not None:
            try:
                raw = zstd_decompress(raw)
            except ValueError as e:
                raise ValueError(f"{key.decode()}: {e}") from e
        if len(raw) != chunk_bytes:
            raise ValueError(f"{key.decode()}: {len(raw)} bytes, a chunk "
                             f"of {list(chunks)} {dtype} is {chunk_bytes}")
        block = np.frombuffer(raw, np.dtype(meta["dtype"])).reshape(chunks)
        sl = tuple(slice(i * ch, min((i + 1) * ch, s))
                   for i, ch, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    return out


# ---------------------------------------------------------------------------
# orbax
# ---------------------------------------------------------------------------

def is_orbax_dir(path: str) -> bool:
    """An orbax checkpoint: a step directory (``_CHECKPOINT_METADATA``) or
    a directory of numbered step directories."""
    if not os.path.isdir(path):
        return False
    if os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA")):
        return True
    return bool(orbax_steps(path))


def orbax_steps(ckpt_dir: str) -> List[int]:
    """The steps of a checkpoint manager's directory, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit()
                  and os.path.exists(os.path.join(ckpt_dir, n,
                                                  "_CHECKPOINT_METADATA")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step of a checkpoint manager's directory, or None."""
    steps = orbax_steps(ckpt_dir)
    return steps[-1] if steps else None


def step_dir(ckpt_dir: str, step: Optional[int] = None) -> str:
    """The step directory: ``ckpt_dir`` itself when it is one (and ``step``
    is None), else its step ``step`` (None: the newest)."""
    if step is None and os.path.exists(
            os.path.join(ckpt_dir, "_CHECKPOINT_METADATA")):
        return ckpt_dir
    steps = orbax_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no orbax checkpoint under {ckpt_dir}")
    step = steps[-1] if step is None else step
    if step not in steps:
        raise FileNotFoundError(f"no step {step} under {ckpt_dir} (steps "
                                f"{steps})")
    return os.path.join(ckpt_dir, str(step))


def _item_dir(step_path: str) -> str:
    for d in (os.path.join(step_path, "default"), step_path):
        if os.path.exists(os.path.join(d, "_METADATA")):
            return d
    raise FileNotFoundError(f"no _METADATA under {step_path} (not an orbax "
                            f"step directory)")


def read_metadata(step_path: str) -> dict:
    """The item's ``_METADATA``, its storage flags checked."""
    item = _item_dir(step_path)
    with open(os.path.join(item, "_METADATA")) as f:
        meta = json.load(f)
    for field, want in (("use_ocdbt", True), ("use_zarr3", False)):
        if meta.get(field, want) != want:
            raise ValueError(f"{item}/_METADATA: {field} "
                             f"{json.dumps(meta.get(field))} is not read "
                             f"(only {json.dumps(want)})")
    return meta


def read_orbax(step_path: str) -> Dict[str, np.ndarray]:
    """Every array of an orbax step directory, by orbax's parameter name,
    in its stored dtype and shape."""
    read_metadata(step_path)
    with OcdbtStore(_item_dir(step_path)) as store:
        names = [k[:-len(b"/.zarray")].decode() for k in store.keys()
                 if k.endswith(b"/.zarray")]
        return {n: read_array(store, n) for n in names}
