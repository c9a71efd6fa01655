"""Which collectives a gloo group runs on CUDA tensors, and how fast: two
ranks on one card, each collective in a world of its own (a collective
that crashes its processes takes no other down with it).

    python tools/gloo_cuda_probe.py

Phase 32 of ``chip_smoke.py`` runs two ranks on the one card over gloo,
since NCCL refuses two ranks on one device; this probe is where the
tensor-parallel helpers' choices come from.  Each line names a
collective (``torch.distributed._functional_collectives`` and
``DTensor`` redistributions on a (data 1, model 2) ``DeviceMesh``), the
ranks' exit codes and what each rank printed.  ``bandwidth`` times a
32 MB and an 8 KB all-reduce over the pair with the host clock after a
synchronise, beside the card's name and power limit.
"""
from __future__ import annotations

import datetime
import subprocess
import sys
import tempfile
import time

TESTS = ("all_reduce_sum", "all_reduce_max", "all_gather", "reduce_scatter",
         "all_gather_list", "broadcast", "distribute", "data1_all_gather",
         "data1_reduce_scatter", "data1_all_reduce", "redistribute_partial",
         "redistribute_replicate", "bandwidth")


def _run(name: str):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data",
                                                            "model"))
    rank = dist.get_rank()
    x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
    w = torch.arange(16., device="cuda").reshape(4, 4)
    world, data = dist.group.WORLD, mesh.get_group("data")
    if name == "all_reduce_sum":
        return funcol.all_reduce(x, "sum", world)
    if name == "all_reduce_max":
        return funcol.all_reduce(x, "max", world)
    if name == "all_gather":
        return funcol.all_gather_tensor(x, 0, world)
    if name == "reduce_scatter":
        return funcol.reduce_scatter_tensor(x, "sum", 0, world)
    if name == "all_gather_list":
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x)
        return torch.cat(out)
    if name == "broadcast":
        y = x.clone()
        dist.broadcast(y, 0)
        return y
    if name == "distribute":
        return distribute_tensor(w, mesh, [Shard(0), Shard(1)]).to_local()
    if name == "data1_all_gather":
        return funcol.all_gather_tensor(x, 0, data)
    if name == "data1_reduce_scatter":
        return funcol.reduce_scatter_tensor(x, "sum", 0, data)
    if name == "data1_all_reduce":
        return funcol.all_reduce(x, "sum", data)
    if name == "redistribute_partial":
        return DTensor.from_local(w, mesh, [Partial(), Shard(1)],
                                  run_check=False).redistribute(
                                      mesh, [Shard(0), Shard(1)]).to_local()
    if name == "redistribute_replicate":
        return DTensor.from_local(w, mesh, [Shard(0), Shard(1)],
                                  run_check=False).redistribute(
                                      mesh, [Replicate(), Shard(1)]).to_local()
    times = {}
    for label, n, reps in (("32 MB", 8 << 20, 5), ("8 KB", 2048, 100)):
        y = torch.ones(n, device="cuda")
        for _ in range(3):
            funcol.all_reduce(y, "sum", world).wait()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            funcol.all_reduce(y, "sum", world).wait()
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0) / reps * 1e3
    return ", ".join(f"{k} all-reduce {v:.4f} ms" for k, v in times.items())


def _rank(rank: int, store: str, name: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    y = _run(name)
    if hasattr(y, "wait"):
        y = y.wait()
    torch.cuda.synchronize()
    shown = y.flatten().tolist()[:16] if hasattr(y, "flatten") else y
    print(f"rank {rank} {name} ok {shown}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    for name in TESTS:
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen(
                [sys.executable, __file__, str(r), f"{tmp}/store", name],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(2)]
            outs = []
            for proc in procs:
                try:
                    out, _ = proc.communicate(timeout=90)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out, _ = proc.communicate()
                outs.append(out.strip().splitlines()[-1:] or [""])
        print(f"{name}: exit codes {[p.returncode for p in procs]}; "
              + " | ".join(o[0][-200:] for o in outs), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4:
        _rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    else:
        main()
