"""Post-repack layout cache: skip the GGUF decode and repack on warm boots.

The load path spends its cold time decoding GGML wire blocks and repacking
them into the device layout (``quant.repack``). That work is deterministic
per (file, repack version), so the repacked arrays are persisted next to the
model on the first load and memory-mapped on later boots. The on-disk format
is the JAX package's (v6), so a cache directory written by either package is
read by the other:

    manifest.json   {"version", "fingerprint", "tensors": {name: meta}}
    data.bin        ONE blob: every tensor's arrays appended 64-B aligned,
                    in load order; meta records (offset, nbytes, dtype,
                    shape) per array

One blob instead of per-array files because a warm boot is bound by the copy
to the card: ``runtime.device_upload`` memory-maps ``data.bin`` and ships
chunks of consecutive whole tensors in single copies, carving them into
per-tensor arrays on the card. Arrays are stored in the canonical COMPACT
scale layout (``quant.repack`` always emits it), about 30% fewer bytes than
the flat layout for 4-bit formats; the flat or mixed relayout happens on the
card (or on the host, ``quant.repack.flatten_repacked``).

The manifest is written last (atomic rename), so a crash mid-population
leaves no valid manifest and the next boot rebuilds. Fresh builds write
``data.bin.<pid>.tmp`` and rename it at finalize; appending to an existing
valid blob takes an exclusive flock (losers skip cache writes but keep
reading). The fingerprint is a fast content check: file size + sha256 of
the first and last 4 MiB, with the JAX package's ``:iq=`` suffix (its
``LGT_IQ_CODES`` knob), so both packages agree on the key.

Env: ``LGT_LAYOUT_CACHE=0`` disables; ``LGT_LAYOUT_CACHE_DIR`` relocates
(keyed by the model's absolute path; useful when the models volume is
read-only).
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np

from ..quant.repack import RepackedWeight

_VERSION = 6   # bump when the repacked layout changes (invalidates caches)
#              v6: iq2 packed4 codes switched to the affine signed map
#              (halved stored d)
#              v5: IQ codebook formats store native-width codes (4-bit
#              sign|mag, 2-bit trits) + wire-density hierarchical scales
_PROBE = 4 * 1024 * 1024
_ALIGN = 64


def _fingerprint(path: Path) -> str:
    st = path.stat()
    h = hashlib.sha256()
    h.update(str(st.st_size).encode())
    with open(path, "rb") as f:
        h.update(f.read(_PROBE))
        if st.st_size > 2 * _PROBE:
            f.seek(-_PROBE, os.SEEK_END)
            h.update(f.read(_PROBE))
    return h.hexdigest()


class LayoutCache:
    """Per-model repack cache over one blob file.

    ``get`` returns memmap-backed weights; ``put`` appends to the active
    blob; ``entries_in_offset_order`` feeds the bulk device-upload path.
    """

    ARRAYS = ("codes", "d", "sc", "dmin", "mn")

    def __init__(self, cache_dir: Path, fingerprint: str):
        self.dir = cache_dir
        self.fingerprint = fingerprint
        self.tensors: dict[str, dict] = {}
        self._dirty = False
        self._blob: Path | None = None       # active blob (reads + appends)
        self._tmp_blob = False               # blob is a tmp awaiting rename
        self._fh = None                      # append handle, opened lazily
        self._append_off = 0
        self._writable = True
        manifest = cache_dir / "manifest.json"
        if manifest.exists():
            try:
                m = json.loads(manifest.read_text())
                if (m.get("version") == _VERSION
                        and m.get("fingerprint") == fingerprint
                        and (cache_dir / "data.bin").exists()):
                    self.tensors = m["tensors"]
                    self._blob = cache_dir / "data.bin"
            except (json.JSONDecodeError, KeyError, OSError):
                pass

    @staticmethod
    def open(model_path: str | Path) -> "LayoutCache | None":
        if os.environ.get("LGT_LAYOUT_CACHE", "1").lower() in ("0", "false", "no"):
            return None
        model_path = Path(model_path)
        base = os.environ.get("LGT_LAYOUT_CACHE_DIR")
        if base:
            # key by absolute path, not just basename: two models named
            # model.gguf in different directories must not share (and
            # repeatedly clobber) one cache dir
            tag = hashlib.sha256(
                str(model_path.resolve()).encode()).hexdigest()[:12]
            cache_dir = Path(base) / f"{model_path.name}.{tag}.lcache"
        else:
            cache_dir = model_path.with_name(model_path.name + ".lcache")
        try:
            cache_dir.mkdir(parents=True, exist_ok=True)
            fp = _fingerprint(model_path)
        except OSError:
            return None
        # the IQ code-layout knob changes what repack EMITS (int8 values
        # vs packed4 codes) — flipping it must invalidate cached entries
        fp += ":iq=" + os.environ.get("LGT_IQ_CODES", "int8").lower()
        return LayoutCache(cache_dir, fp)

    # -- read ---------------------------------------------------------------
    @property
    def blob_path(self) -> Path | None:
        """The file current entries' offsets point into (may be a tmp)."""
        return self._blob

    def _flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def get(self, name: str) -> RepackedWeight | None:
        meta = self.tensors.get(name)
        if meta is None or self._blob is None:
            return None
        self._flush()   # entries put() this session must be readable
        arrays: dict[str, np.ndarray | None] = {}
        try:
            for field in self.ARRAYS:
                spec = meta["arrays"].get(field)
                if spec is None:
                    arrays[field] = None
                    continue
                off, _nb, dtype, shape = spec
                arrays[field] = np.memmap(self._blob, dtype=np.dtype(dtype),
                                          mode="r", offset=off,
                                          shape=tuple(shape))
        except (OSError, ValueError):
            return None
        return RepackedWeight(
            codes=arrays["codes"], d=arrays["d"], sc=arrays["sc"],
            dmin=arrays["dmin"], mn=arrays["mn"],
            fmt=meta["fmt"], bits=meta["bits"], sub_size=meta["sub_size"],
            d_size=meta["d_size"], code_bias=meta["code_bias"],
            out_features=meta["out"], in_features=meta["in"],
        )

    def entries_in_offset_order(self, names) -> list[tuple[str, dict]]:
        """(name, meta) for ``names``, sorted by first array offset —
        consecutive entries are physically adjacent in the blob."""
        self._flush()
        out = [(n, self.tensors[n]) for n in names if n in self.tensors]
        out.sort(key=lambda kv: min(
            spec[0] for spec in kv[1]["arrays"].values() if spec is not None))
        return out

    # -- write --------------------------------------------------------------
    def _open_for_append(self) -> bool:
        """Lazily open the blob for appending.  Returns writability."""
        if self._fh is not None:
            # a failed put() latches _writable False while the handle stays
            # open; appending past a partial write would desync the
            # manifest offsets from the real file positions
            return self._writable
        if not self._writable:
            return False
        try:
            if self._blob is not None and not self._tmp_blob:
                # extend an existing published blob: exclusive lock so two
                # processes can't interleave appends (loser reads only)
                fh = open(self._blob, "r+b")
                try:
                    fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    fh.close()
                    self._writable = False
                    return False
                fh.seek(0, os.SEEK_END)
            else:
                # fresh build: process-private tmp, atomically renamed at
                # finalize; concurrent builders produce byte-identical blobs
                # so whichever rename lands last is consistent either way
                import time
                for stale in self.dir.glob("*.tmp"):
                    try:
                        if stale.stat().st_mtime < time.time() - 3600:
                            stale.unlink(missing_ok=True)
                    except OSError:
                        pass
                for legacy in self.dir.glob("[0-9][0-9][0-9][0-9]_*.bin"):
                    legacy.unlink(missing_ok=True)   # pre-v4 per-array files
                self._blob = self.dir / f"data.bin.{os.getpid()}.tmp"
                self._tmp_blob = True
                fh = open(self._blob, "wb")
            self._fh = fh
            self._append_off = fh.tell()
            return True
        except OSError:
            self._writable = False
            return False

    def put(self, name: str, rp: RepackedWeight) -> None:
        if name in self.tensors or not self._open_for_append():
            return
        arrays: dict[str, list | None] = {}
        try:
            for field in self.ARRAYS:
                arr = getattr(rp, field)
                if arr is None:
                    arrays[field] = None
                    continue
                arr = np.ascontiguousarray(arr)
                pad = (-self._append_off) % _ALIGN
                if pad:
                    self._fh.write(b"\0" * pad)
                    self._append_off += pad
                self._fh.write(arr.tobytes())
                arrays[field] = [self._append_off, arr.nbytes,
                                 arr.dtype.str, list(arr.shape)]
                self._append_off += arr.nbytes
        except OSError:
            self._writable = False
            return
        self.tensors[name] = dict(
            fmt=rp.fmt, bits=rp.bits, sub_size=rp.sub_size, d_size=rp.d_size,
            code_bias=rp.code_bias, out=rp.out_features, **{"in": rp.in_features},
            arrays=arrays,
        )
        self._dirty = True

    def finalize(self) -> None:
        """Atomically publish the blob + manifest (call after a full load)."""
        if self._fh is not None:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except OSError:
                pass
        if not self._dirty:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            return
        try:
            if self._tmp_blob:
                self._fh.close()
                self._fh = None
                os.replace(self._blob, self.dir / "data.bin")
                self._blob = self.dir / "data.bin"
                self._tmp_blob = False
            payload = json.dumps({"version": _VERSION,
                                  "fingerprint": self.fingerprint,
                                  "tensors": self.tensors})
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self.dir / "manifest.json")
        except OSError:
            pass
        finally:
            if self._fh is not None:
                self._fh.close()   # releases the flock
                self._fh = None
        self._dirty = False
