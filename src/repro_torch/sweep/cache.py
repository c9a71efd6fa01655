"""Content-hashed on-disk result cache for the port's sweeps (PyTorch port
of ``repro.sweep.cache``).

One sweep = one ``sweep_torch-<device type>_<hash>.npz`` under the cache
directory (``$REPRO_SWEEP_CACHE`` or ``.sweep_cache/``, the reference's
rule), where ``<hash>`` is :meth:`SweepSpec.content_hash`.  The npz holds
the per-record result arrays verbatim (float32, so reloads are
bit-identical) and a JSON manifest with the full canonical spec, which
:func:`load` verifies against the requesting spec.  Stack geometry is
not stored: it is rebuilt from the point on load.

The namespace is the port's own.  Its results are float32 from another
summation order than the reference's, and they differ between the CPU
and the card in the last bit, so the file name and the manifest carry
``repro_torch`` and the device type: a reference entry is never served
to the port, nor a CPU entry to the card, nor the other way round, even
where one directory holds them all.

A corrupt or truncated cache file is a MISS, not an error: the sweep
recomputes and overwrites it.  Hits, misses, corrupt files and stores
are counted under ``sweep/cache/*`` when :mod:`repro_torch.obs` is
enabled.
"""
from __future__ import annotations

import json
import os
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs
from repro_torch.stack import dram, feedback
from repro_torch.stack.spec import dram_on_logic
from repro_torch.sweep.engine import SweepRecord, SweepResult, resolve_fb
from repro_torch.sweep.spec import SweepPoint, SweepSpec

#: the manifest's namespace: entries of another package are refused
NAMESPACE = "repro_torch"

_ARRAYS = ("peak_C", "min_C", "residual_C", "throttle", "refresh_W",
           "leak_W", "dyn_W")

#: everything a damaged npz can throw while being opened/read: not a
#: zip at all, zip ok but members truncated/absent, manifest not JSON
_CORRUPT_ERRORS = (zipfile.BadZipFile, zlib.error, KeyError, ValueError,
                   EOFError, OSError, json.JSONDecodeError)


def default_cache_dir() -> Path:
    return Path(os.environ.get("REPRO_SWEEP_CACHE", ".sweep_cache"))


def _device_type(device) -> str:
    return torch.device(device).type


def path_for(spec: SweepSpec, cache_dir=None, *, device="cuda") -> Path:
    base = Path(cache_dir) if cache_dir is not None else default_cache_dir()
    return base / (f"sweep_torch-{_device_type(device)}_"
                   f"{spec.content_hash()}.npz")


def store(result: SweepResult, cache_dir=None, *, device="cuda") -> Path:
    """Persist a sweep result computed on ``device``; returns the written
    path."""
    path = path_for(result.spec, cache_dir, device=device)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload: dict[str, np.ndarray] = {}
    for i, rec in enumerate(result.records):
        for name in _ARRAYS:
            payload[f"r{i}_{name}"] = getattr(rec.report, name)
    manifest = {
        "namespace": NAMESPACE,
        "device": _device_type(device),
        "spec": result.spec.canonical(),
        "records": [{"machine": r.machine,
                     "point": [r.point.workload, r.point.size,
                               r.point.n_dram, r.point.fb_mode,
                               r.point.policy]}
                    for r in result.records],
    }
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, manifest=np.array(json.dumps(manifest)), **payload)
    os.replace(tmp, path)
    obs.count("sweep/cache/store")
    if obs.is_enabled():
        obs.count("sweep/cache/bytes_written", path.stat().st_size)
    return path


def load(spec: SweepSpec, cache_dir=None, *,
         device="cuda") -> SweepResult | None:
    """Load the cached sweep for ``spec`` computed on ``device``'s type;
    None on a miss, a manifest of another spec, namespace or device type,
    or a corrupt/truncated file (recompute and overwrite rather than fail
    the sweep)."""
    path = path_for(spec, cache_dir, device=device)
    if not path.exists():
        obs.count("sweep/cache/miss")
        return None
    try:
        result = _read(spec, path, _device_type(device))
    except _CORRUPT_ERRORS:
        obs.count("sweep/cache/corrupt")
        obs.count("sweep/cache/miss")
        return None
    if result is None:
        obs.count("sweep/cache/miss")
        return None
    obs.count("sweep/cache/hit")
    if obs.is_enabled():
        obs.count("sweep/cache/bytes_read", path.stat().st_size)
    return result


def _read(spec: SweepSpec, path: Path, device_type: str
          ) -> SweepResult | None:
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        if (manifest.get("namespace") != NAMESPACE
                or manifest.get("device") != device_type
                or manifest["spec"] != spec.canonical()):
            return None
        interval_dt = spec.t_end / spec.n_intervals
        records = []
        for i, meta in enumerate(manifest["records"]):
            w, size, n_dram, fb_mode, policy = meta["point"]
            point = SweepPoint(w, int(size), int(n_dram), fb_mode,
                               policy)
            stack_spec = dram_on_logic(int(n_dram))
            base_ref = dram.DRAMFloorplan(die_w_mm=1.0).base_refresh_W() \
                * int(n_dram)
            arrays = {name: z[f"r{i}_{name}"] for name in _ARRAYS}
            report = feedback.StackReport(
                label=f"{point.label}/{meta['machine']}",
                interval_s=interval_dt, spec=stack_spec,
                base_refresh_W=base_ref,
                tol_C=resolve_fb(fb_mode, policy=policy).picard_tol_C,
                **arrays)
            records.append(SweepRecord(point=point,
                                       machine=meta["machine"],
                                       report=report))
    return SweepResult(spec=spec, records=tuple(records), from_cache=True)
