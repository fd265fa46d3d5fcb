"""The binary metrics log: a native writer and its reader.

`FastLogWriter` writes tagged float32 records through the C++ writer of
`native/fastlog.cpp`, built with g++ at first use into the git-ignored
`build/` tree beside the kernels (`ops/_build.BUILD_DIR`, keyed by a hash
of the source and flags) and driven through ctypes; its bulk
`write_rows` logs a whole (T, d) channel in one call.  If the writer
cannot be built, opening a writer raises: nothing falls back silently.
`FastLogWriter(path, force_python=True)` writes the same bytes in Python
when the caller asks for it.

Format (little-endian, see fastlog.cpp): 8-byte magic "FLOG0001";
tagdef = u8 1, u16 id, u16 len, name; record = u8 2, u16 id, i64 step,
u32 n, n * f32.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..ops._build import BUILD_DIR

MAGIC = b"FLOG0001"
_KIND_TAGDEF = 1
_KIND_RECORD = 2

NATIVE_SRC = Path(__file__).resolve().parents[1] / "native" / "fastlog.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
_lib = None


def native_library_path() -> Path:
    """Where the native writer's build lives: build/kernels/fastlog_<hash
    of the source and flags>.so."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"fastlog_{h.hexdigest()[:16]}.so"


def load_native():
    """The native writer's ctypes library, compiled with g++ on first use
    (RuntimeError if g++ is missing or fails)."""
    global _lib
    if _lib is not None:
        return _lib
    out = native_library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                                   str(NATIVE_SRC)], capture_output=True,
                                  text=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as err:
            raise RuntimeError(f"the native fastlog writer cannot be built "
                               f"with g++: {err}") from err
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {NATIVE_SRC.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    _lib = _bind(ctypes.CDLL(str(out)))
    return _lib


def _bind(lib):
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.c_char_p]
    lib.fl_tag.restype = ctypes.c_int
    lib.fl_tag.argtypes = [ctypes.c_void_p, ctypes.c_uint16, ctypes.c_char_p]
    lib.fl_write.restype = ctypes.c_int
    lib.fl_write.argtypes = [ctypes.c_void_p, ctypes.c_uint16,
                             ctypes.c_int64, ctypes.c_void_p,
                             ctypes.c_uint32]
    lib.fl_write_rows.restype = ctypes.c_int
    lib.fl_write_rows.argtypes = [ctypes.c_void_p, ctypes.c_uint16,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_uint32]
    lib.fl_flush.restype = ctypes.c_int
    lib.fl_flush.argtypes = [ctypes.c_void_p]
    lib.fl_close.restype = None
    lib.fl_close.argtypes = [ctypes.c_void_p]
    return lib


def _f32_rows(values) -> np.ndarray:
    """values (a tensor, array or number) as a contiguous float32 array
    on the host."""
    if hasattr(values, "detach"):
        values = values.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(values), dtype=np.float32)


class FastLogWriter:
    """Tagged float32 record writer.  `native` says which writer made the
    file: the native one unless the caller passed force_python=True."""

    def __init__(self, path: str, force_python: bool = False):
        self.path = path
        self._tags: Dict[str, int] = {}
        self._lib = None if force_python else load_native()
        self._h = None
        self._fh = None
        if self._lib is not None:
            self._h = self._lib.fl_open(os.fsencode(path))
            if not self._h:
                raise OSError(f"fastlog: cannot open {path} for writing")
        else:
            self._fh = open(path, "wb")
            self._fh.write(MAGIC)
        self.native = self._lib is not None

    def _check(self, rc, what):
        if rc != 0:
            raise OSError(f"fastlog: {what} failed on {self.path}")

    def _tag_id(self, tag: str) -> int:
        tid = self._tags.get(tag)
        if tid is None:
            tid = len(self._tags)
            if tid > 0xFFFF:
                raise ValueError("too many distinct tags")
            self._tags[tag] = tid
            name = tag.encode()
            if self._h is not None:
                self._check(self._lib.fl_tag(self._h, tid, name), "fl_tag")
            else:
                self._fh.write(struct.pack("<BHH", _KIND_TAGDEF, tid,
                                           len(name)) + name)
        return tid

    def write(self, tag: str, step: int, value) -> None:
        a = np.atleast_1d(_f32_rows(value)).reshape(-1)
        tid = self._tag_id(tag)
        if self._h is not None:
            self._check(self._lib.fl_write(
                self._h, tid, int(step), a.ctypes.data_as(ctypes.c_void_p),
                a.size), "fl_write")
        else:
            self._fh.write(struct.pack("<BHqI", _KIND_RECORD, tid,
                                       int(step), a.size) + a.tobytes())

    def write_rows(self, tag: str, values, step0: int = 0,
                   stride: int = 1) -> None:
        """Log a whole (T,) or (T, ...) channel: row t (flattened) at step
        step0 + t * stride, in one native call."""
        a = _f32_rows(values)
        a = a.reshape(a.shape[0], -1) if a.ndim != 1 else a[:, None]
        a = np.ascontiguousarray(a)
        tid = self._tag_id(tag)
        if self._h is not None:
            self._check(self._lib.fl_write_rows(
                self._h, tid, int(step0), int(stride),
                a.ctypes.data_as(ctypes.c_void_p), a.shape[0], a.shape[1]),
                "fl_write_rows")
        else:
            head = struct.pack("<BH", _KIND_RECORD, tid)
            for r in range(a.shape[0]):
                self._fh.write(head + struct.pack(
                    "<qI", step0 + r * stride, a.shape[1]) + a[r].tobytes())

    def flush(self) -> None:
        if self._h is not None:
            self._check(self._lib.fl_flush(self._h), "fl_flush")
        else:
            self._fh.flush()

    def close(self) -> None:
        if self._h is not None:
            self._lib.fl_close(self._h)
            self._h = None
        elif self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_fastlog(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """A fastlog file read back as {tag: (steps (N,) int64, values (N, d)
    float32)}.  Raises ValueError on a file that is not a fastlog, on a
    record of unknown kind or cut short, and on a ragged tag (records of
    one tag with different lengths)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != MAGIC:
        raise ValueError("not a fastlog file: %s" % path)
    names: Dict[int, str] = {}
    steps: Dict[int, list] = {}
    vals: Dict[int, list] = {}
    off, end = 8, len(blob)

    def need(n):
        if off + n > end:
            raise ValueError("fastlog %s: record cut short at byte %d"
                             % (path, off))

    while off < end:
        kind = blob[off]
        off += 1
        if kind == _KIND_TAGDEF:
            need(4)
            tid, nlen = struct.unpack_from("<HH", blob, off)
            off += 4
            need(nlen)
            names[tid] = blob[off:off + nlen].decode()
            off += nlen
            steps.setdefault(tid, [])
            vals.setdefault(tid, [])
        elif kind == _KIND_RECORD:
            need(14)
            tid, step, n = struct.unpack_from("<HqI", blob, off)
            off += 14
            need(4 * n)
            vals.setdefault(tid, []).append(
                np.frombuffer(blob, dtype="<f4", count=n, offset=off).copy())
            steps.setdefault(tid, []).append(step)
            off += 4 * n
        else:
            raise ValueError("corrupt fastlog record kind %d at byte %d of %s"
                             % (kind, off - 1, path))
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for tid, name in names.items():
        vv = vals.get(tid, [])
        if len({v.size for v in vv}) > 1:
            raise ValueError("fastlog %s: tag %r is ragged (record lengths "
                             "%s)" % (path, name, sorted({v.size
                                                           for v in vv})))
        out[name] = (np.asarray(steps.get(tid, []), dtype=np.int64),
                     np.stack(vv) if vv
                     else np.zeros((0, 0), dtype=np.float32))
    return out
