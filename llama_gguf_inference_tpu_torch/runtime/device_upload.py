"""Bulk upload of cached weights: chunked blob copies and a carve on the card.

A warm boot reads every quantized weight from the layout cache
(``runtime.layout_cache``: one ``data.bin`` blob, arrays stored COMPACT).
Instead of one pageable copy per array, this module

1. memory-maps ``data.bin`` (on a cold boot still ``data.bin.<pid>.tmp``),
2. groups consecutive whole tensors into chunks of ``LGT_UPLOAD_CHUNK_MB``
   (default 512; a tensor larger than that is a chunk of its own),
3. stages each chunk in one of two pinned host buffers and copies it to the
   card with ``non_blocking=True`` on a side stream, so the host reads the
   next chunk while the card copies and carves this one; an event recorded
   after each copy is waited on before its buffer is refilled,
4. carves every tensor out of its chunk on the card: slice, view as the
   dtype, reshape, then the compact->flat or compact->mixed relayout the
   weight's ``quant.repack.device_scale_layout`` asks for (the codes'
   transpose and one f32 ``d * sc`` product per sub-block), equal bit for
   bit to the host's ``flatten_repacked`` / ``mixed_repacked``. Every carved
   array is allocated once and owns its storage (no view keeps a chunk
   alive, and no temporary is made).

On the CPU there is no staging: each chunk is read from the memory map into
a tensor and carved by the same code.

Env: ``LGT_UPLOAD=tensor`` keeps the per-tensor path; ``LGT_UPLOAD_CHUNK_MB``
sets the chunk size.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.linear import QuantLinear
from ..quant.repack import device_scale_layout

_FIELDS = ("codes", "d", "sc", "dmin", "mn")


def upload_enabled() -> bool:
    return os.environ.get("LGT_UPLOAD", "blob").lower() != "tensor"


def _chunk_bytes() -> int:
    return int(os.environ.get("LGT_UPLOAD_CHUNK_MB", "512")) * 1024 * 1024


def _torch_dtype(dstr: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dstr))).dtype


def _span(meta: dict) -> tuple[int, int]:
    specs = [s for s in meta["arrays"].values() if s is not None]
    return min(s[0] for s in specs), max(s[0] + s[1] for s in specs)


def _carve_one(chunk: torch.Tensor, base: int, meta: dict) -> QuantLinear:
    """One tensor's arrays cut out of ``chunk`` (a 1-D uint8 tensor holding
    the blob from offset ``base``), relaid to its device scale layout. Each
    output is allocated once, in its final layout, and owns its storage (a
    view would keep the whole chunk alive)."""
    arrs: dict[str, torch.Tensor] = {}
    for field in _FIELDS:
        spec = meta["arrays"].get(field)
        if spec is None:
            continue
        off, nbytes, dstr, shape = spec
        seg = chunk[off - base: off - base + nbytes]
        arrs[field] = seg.view(_torch_dtype(dstr)).reshape(shape)

    out_f, in_f = meta["out"], meta["in"]
    bits, sub, dsz = meta["bits"], meta["sub_size"], meta["d_size"]
    layout = "compact" if dsz == sub else device_scale_layout(
        bits, meta["fmt"], has_min="dmin" in arrs, bias=meta["code_bias"])
    if layout == "compact":
        out = {f: a.clone() for f, a in arrs.items()}
        return _quant_linear(meta, out, dsz, 0)
    # compact -> flat, as quant.repack.flatten_repacked: the packed code
    # bytes (t_p, s, σ) -> (t_p, σ, s), the scale the f32 product d * sc per
    # sub-block (u8/i8 sc converted inside the product)
    g, nd = dsz // sub, in_f // dsz
    groups = sub * bits // 8
    dev = chunk.device

    def expand(d_arr, sc_arr):
        res = torch.empty((out_f, nd, g), dtype=torch.float32, device=dev)
        if sc_arr is None:
            res.copy_(d_arr[:, :, None].expand(out_f, nd, g))
        else:
            torch.mul(d_arr[:, :, None], sc_arr.reshape(out_f, g, nd).transpose(1, 2), out=res)
        return res.reshape(out_f, nd * g)

    codes = torch.empty((out_f, groups, nd, g), dtype=arrs["codes"].dtype, device=dev)
    codes.copy_(arrs["codes"].reshape(out_f, groups, g, nd).transpose(2, 3))
    out = {"codes": codes.reshape(out_f, groups * nd * g), "d": expand(arrs["d"], arrs.get("sc"))}
    if "dmin" not in arrs:
        return _quant_linear(meta, out, sub, 0)
    if layout == "mixed":
        # quant.repack.mixed_repacked: the min side stays compact
        out["dmin"], out["mn"] = arrs["dmin"].clone(), arrs["mn"].clone()
        return _quant_linear(meta, out, sub, dsz)
    out["dmin"] = expand(arrs["dmin"], arrs.get("mn"))
    return _quant_linear(meta, out, sub, 0)


def _quant_linear(meta: dict, arrs: dict, d_size: int, min_size: int) -> QuantLinear:
    return QuantLinear(
        codes=arrs["codes"], d=arrs["d"], sc=arrs.get("sc"), dmin=arrs.get("dmin"),
        mn=arrs.get("mn"), fmt=meta["fmt"], bits=meta["bits"], sub_size=meta["sub_size"],
        d_size=d_size, code_bias=meta["code_bias"], out_features=meta["out"],
        in_features=meta["in"], min_size=min_size)


def _chunks(entries: list[tuple[str, dict]], limit: int):
    """Physically consecutive tensors grouped into chunks of at most
    ``limit`` bytes (a larger tensor alone); returns (groups, spans)."""
    groups: list[list[tuple[str, dict]]] = []
    spans: list[tuple[int, int]] = []
    for name, meta in entries:
        lo, hi = _span(meta)
        if groups and hi - spans[-1][0] <= limit:
            groups[-1].append((name, meta))
            spans[-1] = (spans[-1][0], max(spans[-1][1], hi))
        else:
            groups.append([(name, meta)])
            spans.append((lo, hi))
    return groups, spans


def bulk_upload(cache, names: list[str], device: str | torch.device = "cuda",
                stats: dict | None = None) -> dict[str, QuantLinear]:
    """Ship ``names`` from the cache blob to ``device``.

    Returns {name: QuantLinear}, every array equal bit for bit to
    ``quant.repack.to_quant_linear(cache.get(name), device)``'s. ``stats``,
    when given, gets the seconds spent staging chunks on the host
    (``stage_s``), copying them to the card (``upload_s``, device time),
    carving (``carve_s``, device time on the card) and in all
    (``bulk_s``), and the bytes shipped (``bulk_bytes``)."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    entries = cache.entries_in_offset_order(names)
    if len(entries) != len(set(names)):
        missing = set(names) - {n for n, _ in entries}
        raise KeyError(f"tensors not in layout cache: {sorted(missing)[:5]}")
    blob = np.memmap(cache.blob_path, dtype=np.uint8, mode="r")
    groups, spans = _chunks(entries, _chunk_bytes())
    results: dict[str, QuantLinear] = {}
    st = {"stage_s": 0.0, "upload_s": 0.0, "carve_s": 0.0,
          "bulk_bytes": sum(hi - lo for lo, hi in spans)}
    if dev.type == "cuda":
        _upload_card(blob, groups, spans, dev, results, st)
    else:
        for group, (lo, hi) in zip(groups, spans):
            t0 = time.perf_counter()
            chunk = torch.from_numpy(np.array(blob[lo:hi]))
            t1 = time.perf_counter()
            for name, meta in group:
                results[name] = _carve_one(chunk, lo, meta)
            st["stage_s"] += t1 - t0
            st["carve_s"] += time.perf_counter() - t1
    del blob
    st["bulk_s"] = time.perf_counter() - t_start
    if stats is not None:
        for k, v in st.items():
            stats[k] = stats.get(k, 0) + v
    return results


def _upload_card(blob, groups, spans, dev, results, st) -> None:
    """Two pinned buffers in turn: the host fills one while the side stream
    copies the other to the card and the current stream carves it."""
    size = max(hi - lo for lo, hi in spans)
    pinned = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
              for _ in range(min(2, len(groups)))]
    freed: list[torch.cuda.Event | None] = [None] * len(pinned)
    side = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)
    timing = []
    for i, (group, (lo, hi)) in enumerate(zip(groups, spans)):
        k = i % len(pinned)
        if freed[k] is not None:
            freed[k].synchronize()        # the copy that read this buffer is done
        t0 = time.perf_counter()
        host = pinned[k][:hi - lo]
        np.copyto(host.numpy(), blob[lo:hi])
        st["stage_s"] += time.perf_counter() - t0
        chunk = torch.empty(hi - lo, dtype=torch.uint8, device=dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        side.wait_stream(main)            # the chunk's memory, in main's order
        with torch.cuda.stream(side):
            ev[0].record(side)
            chunk.copy_(host, non_blocking=True)
            ev[1].record(side)
        freed[k] = ev[1]
        main.wait_event(ev[1])
        ev[2].record(main)
        for name, meta in group:
            results[name] = _carve_one(chunk, lo, meta)
        ev[3].record(main)
        timing.append(ev)
        del chunk                         # freed in main's order, after the carve
    torch.cuda.synchronize(dev)
    for ev in timing:
        st["upload_s"] += ev[0].elapsed_time(ev[1]) / 1e3
        st["carve_s"] += ev[2].elapsed_time(ev[3]) / 1e3
