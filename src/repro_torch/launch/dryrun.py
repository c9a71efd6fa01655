"""Multi-pod dry run of the port: build every (architecture x shape x
mesh) cell's step on the fake process group, run it once on fake
tensors, and record memory, cost, collectives and roofline terms (the
port's ``launch/dryrun.py``).

The reference lowers and compiles each cell with XLA on 512 placeholder
devices.  Here the placeholders are the ranks of ``torch.distributed`` 's
fake process group (``FakeStore``, world size 256 for ``pod16x16`` or
512 for ``pod2x16x16``; a test utility of PyTorch's,
``torch.testing._internal``), one process standing for rank 0: the
step is built by ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` on ``make_production_mesh`` with ``device="cpu"``
and run once on fake tensors (``launch.costing.step_cost``), so no
storage is allocated and CUDA is never initialised.  ``lower_s`` is the
time to build the step, ``compile_s`` the time of the fake run.  Like
the reference's, it is a shape-only run on placeholder devices by design.

Where no process group exists, the fake group of the mesh's size is made
here, and remade between the two meshes of ``--mesh both``; a group of
another size made elsewhere raises.  The roofline seconds are data-sheet
predictions (``launch/roofline.py``: H100 SXM peaks) for H100s laid out
as the reference's mesh; nothing here is timed or sized for a TPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out artifacts/dryrun_torch
  (per-cell JSON is cached; --force reruns)
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

#: the world size of the fake group this module made, if any
_made: list[int] = []


def fake_group(world_size: int) -> None:
    """Make the default process group the fake one of ``world_size``
    ranks (this process rank 0), unless a group of that size exists.  A
    fake group this module made earlier is replaced; any other group of
    another size raises ``ValueError``."""
    import torch.distributed as dist
    if dist.is_initialized():
        have = dist.get_world_size()
        if have == world_size:
            return
        if not _made:
            raise ValueError(f"the dry run needs a process group of "
                             f"{world_size} ranks; one of {have} exists")
        release_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    _made.append(world_size)


def release_group() -> None:
    """Destroy the fake group this module made, if it made one."""
    import torch.distributed as dist
    if _made and dist.is_initialized():
        dist.destroy_process_group()
    _made.clear()


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, perf_override=None, tag: str = "") -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import roofline as RF
    from repro_torch.launch.cells import perf_for
    from repro_torch.launch.costing import ComponentCoster, step_cost
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import params_sds

    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out = pathlib.Path(out_dir) / mesh_name
    out.mkdir(parents=True, exist_ok=True)
    fname = out / f"{arch}__{shape_name}{tag}.json"
    if fname.exists() and not force:
        return json.loads(fname.read_text())

    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    data_width = 32 if multi_pod else 16
    perf = perf_override or perf_for(arch, shape_name, data_width)
    n_chips = 512 if multi_pod else 256
    fake_group(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod)

    run = step_cost(cfg, cell, mesh, perf, multi_pod=multi_pod)
    coster = ComponentCoster(cfg, cell, mesh, perf, multi_pod=multi_pod)
    t0 = time.time()
    recon = coster.reconstruct({"flops": run.cost["flops"],
                                "bytes_accessed": run.cost["bytes"]},
                               run.cost["wire"])
    t_cost = time.time() - t0
    total = recon["total"]

    mf = RF.model_flops_per_device(cfg, cell, params_sds(cfg), n_chips)
    terms = RF.roofline(
        {"flops": total["flops"], "bytes accessed": total["bytes"]},
        {"total_wire_bytes": total["wire"]}, mf)

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": cell.kind, "n_chips": n_chips,
        "perf": {"remat": perf.remat, "attn_chunk": perf.attn_chunk,
                 "accum_steps": perf.accum_steps},
        "lower_s": round(run.build_s, 1), "compile_s": round(run.run_s, 1),
        "memory": run.memory,
        "cost_raw_scan_once": {"flops": run.cost["flops"],
                               "bytes_accessed": run.cost["bytes"]},
        "cost": {"flops": total["flops"], "bytes_accessed": total["bytes"],
                 "wire_bytes": total["wire"], "costing_s": round(t_cost, 1)},
        "cost_components": {
            name: {"flops": c["cost"]["flops"], "bytes": c["cost"]["bytes"],
                   "wire": c["cost"]["wire"], "true_count": c["true"]}
            for name, c in recon["per_component"].items()},
        "collectives": run.collectives,
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "model_flops_per_device": terms.model_flops,
            "useful_flop_ratio": terms.useful_ratio,
            "compute_fraction_of_bound": terms.roofline_fraction,
        },
    }
    fname.write_text(json.dumps(rec, indent=1))
    return rec


def main() -> None:
    from repro_torch.configs import SHAPES, cell_is_runnable, get_config, \
        list_configs
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    try:
        # one mesh at a time: the fake group is made once a mesh
        for mp in meshes:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            for arch in archs:
                cfg = get_config(arch)
                for shape in shapes:
                    ok, why = cell_is_runnable(cfg, SHAPES[shape])
                    if not ok:
                        print(f"SKIP  {arch:24s} {shape:12s} {mesh_name:11s}"
                              f" ({why})", flush=True)
                        continue
                    t0 = time.time()
                    try:
                        rec = run_cell(arch, shape, mp, args.out,
                                       force=args.force)
                        r = rec["roofline"]
                        print(f"OK    {arch:24s} {shape:12s} {mesh_name:11s}"
                              f" compile={rec['compile_s']:7.1f}s "
                              f"mem/dev={rec['memory']['peak_bytes_per_device'] / 2**30:8.2f}GiB "
                              f"[C {r['compute_s']:.2e} M {r['memory_s']:.2e} "
                              f"N {r['collective_s']:.2e}] dom={r['dominant']}"
                              f" in {time.time() - t0:.1f}s", flush=True)
                    except Exception as e:
                        failures.append((arch, shape, mesh_name, repr(e)))
                        print(f"FAIL  {arch:24s} {shape:12s} {mesh_name:11s} "
                              f"{type(e).__name__}: {e}", flush=True)
                        traceback.print_exc()
            release_group()
    finally:
        release_group()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + "; ".join(f"{a}/{s}/{m}" for a, s, m, _ in failures))
    print("ALL CELLS PASSED")


if __name__ == "__main__":
    main()
