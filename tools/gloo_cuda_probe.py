#!/usr/bin/env python3
"""Which collectives the ``gloo`` backend runs on CUDA tensors, with ranks
that share one card, and how long each takes.

    python3 tools/gloo_cuda_probe.py [--ranks 4] [--mib 16]

Spawns ``--ranks`` processes on ``cuda:0`` over a ``FileStore`` in a temp
directory (no network), builds the ``(ranks // 2, 2)`` ``DeviceMesh`` of
axes ``("data", "model")``, and tries each collective the sharded port
uses, in its tensor form and its list form, on a ``--mib`` MiB f32 tensor
over the whole group and over the ``model`` axis.  Prints one line a
collective: ``ok`` with its mean ms over 5 calls, or the error it raised.
It is a probe: it reports a refused collective rather than failing on it.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time


def _worker(rank, world, store_path, mib, out_dir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.cuda.set_device(0)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(world // 2, 2),
                      mesh_dim_names=("data", "model"))
    dev = torch.device("cuda", 0)
    n = mib * 2 ** 20 // 4
    lines = []

    def probe(name, fn, group):
        gsize = dist.get_world_size(group)
        try:
            fn(group, gsize)  # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(5):
                fn(group, gsize)
            torch.cuda.synchronize()
            lines.append(f"{name}: ok {(time.perf_counter() - t) / 5 * 1e3:.3f} ms")
        except Exception as e:  # a probe reports what the backend refuses
            lines.append(f"{name}: FAILED {type(e).__name__}: {str(e).splitlines()[0][:160]}")

    x = torch.full((n,), float(rank + 1), device=dev)

    def all_reduce(g, s):
        y = x.clone()
        dist.all_reduce(y, group=g)
        torch.cuda.synchronize()
        assert float(y[0]) == sum(range(1, world + 1)) or s != world

    def all_gather_tensor(g, s):
        out = torch.empty(n * s, device=dev)
        dist.all_gather_into_tensor(out, x, group=g)

    def all_gather_list(g, s):
        outs = [torch.empty(n, device=dev) for _ in range(s)]
        dist.all_gather(outs, x, group=g)

    def reduce_scatter_tensor(g, s):
        out = torch.empty(n // s, device=dev)
        dist.reduce_scatter_tensor(out, x, group=g)

    def reduce_scatter_list(g, s):
        out = torch.empty(n // s, device=dev)
        dist.reduce_scatter(out, list(x.chunk(s)), group=g)

    def all_to_all(g, s):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=g)

    def broadcast(g, s):
        y = x.clone()
        dist.broadcast(y, src=dist.get_global_rank(g, 0) if g is not None else 0, group=g)

    groups = {"world": None, "model": mesh.get_group("model"), "data": mesh.get_group("data")}
    for gname, grp in groups.items():
        for fname, fn in (("all_reduce", all_reduce), ("all_gather_into_tensor", all_gather_tensor),
                          ("all_gather(list)", all_gather_list),
                          ("reduce_scatter_tensor", reduce_scatter_tensor),
                          ("reduce_scatter(list)", reduce_scatter_list),
                          ("all_to_all_single", all_to_all), ("broadcast", broadcast)):
            probe(f"{gname} {fname}", fn, grp)
    if rank == 0:
        with open(os.path.join(out_dir, "probe.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mib", type=int, default=16)
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: CUDA is not available", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        mp.spawn(_worker, args=(args.ranks, os.path.join(tmp, "store"), args.mib, tmp),
                 nprocs=args.ranks, join=True)
        print(f"{args.ranks} ranks, {args.mib} MiB f32, spawn to exit "
              f"{time.perf_counter() - t:.1f} s")
        with open(os.path.join(tmp, "probe.txt")) as f:
            print(f.read(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
