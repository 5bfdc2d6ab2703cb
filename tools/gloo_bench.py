"""Gloo collectives between 2 ranks sharing one card.

Without arguments: the latency of an all-reduce at the size of a
tensor-parallel StarCoder2-3B decode step's row-parallel sum ((8, 1,
3,072) fp32): a CUDA tensor handed to gloo, the same staged through the
host by hand (pageable, then pinned), and a host tensor alone; 1,000
calls each after 50 warm-up calls, ms a call printed by rank 0.

With ``--fsdp``: the collectives of an FSDP step at the size of one
StarCoder2-3B layer's bf16 block at dp 2 (``--elements``, default 48 M
values, 96 MB a rank): ``all_gather`` into a list, ``all_gather_into_tensor``,
``all_reduce`` of the whole (2 x the block) buffer and
``reduce_scatter_tensor`` on CUDA tensors, then the last two on pinned
host tensors with the copies to and from the card by hand.  Each variant
runs 2 warm-up calls, the first timed alone (it allocates the pinned
host buffers gloo stages a CUDA tensor through), and ``--reps`` timed
calls; rank 0 prints, as one JSON line, ms a call and GB/s of the rank's
payload (a gather's or a scatter's whole buffer), the first call's ms,
or the error where gloo refuses the call.  Run
on a machine with a GPU:

    python3 tools/gloo_bench.py [--fsdp [--elements N] [--reps R]]
"""
import argparse
import json
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def decode_sum(rank):
    x = torch.randn(8, 1, 3072, device="cuda")
    pinned = torch.empty(x.shape, pin_memory=True)
    res = {}

    def direct():
        y = x.clone(); dist.all_reduce(y); return y

    def staged():
        h = x.cpu(); dist.all_reduce(h); return h.to("cuda")

    def staged_pinned():
        pinned.copy_(x); dist.all_reduce(pinned)
        return pinned.to("cuda", non_blocking=True)

    def host():
        h = pinned.clone(); dist.all_reduce(h); return h

    for name, fn in (("direct", direct), ("staged", staged),
                     ("staged_pinned", staged_pinned), ("host", host),
                     ("direct2", direct)):
        for _ in range(50):
            fn()
        torch.cuda.synchronize(); dist.barrier()
        t = time.perf_counter()
        for _ in range(1000):
            fn()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t) / 1000 * 1e3
    if rank == 0:
        print("ms per all-reduce of (8, 1, 3072) fp32:", res, flush=True)


def fsdp(rank, n, reps):
    block = torch.randn(n, device="cuda").to(torch.bfloat16)
    whole = torch.empty(2 * n, dtype=torch.bfloat16, device="cuda")
    grads = torch.randn(2 * n, device="cuda").to(torch.bfloat16)
    out = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    h_block = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
    h_whole = torch.empty(2 * n, dtype=torch.bfloat16, pin_memory=True)
    h_out = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)

    def gather_list():
        dist.all_gather(list(whole.chunk(2)), block)

    def gather_tensor():
        dist.all_gather_into_tensor(whole, block)

    def reduce_all():
        g = grads.clone(); dist.all_reduce(g); return g.chunk(2)[rank]

    def reduce_scatter():
        dist.reduce_scatter_tensor(out, grads)

    def host_gather():
        h_block.copy_(block)
        dist.all_gather_into_tensor(h_whole, h_block)
        whole.copy_(h_whole, non_blocking=True)

    def host_reduce_scatter():
        h_whole.copy_(grads)
        dist.reduce_scatter_tensor(h_out, h_whole)
        out.copy_(h_out, non_blocking=True)

    res = {"elements": n, "bytes_a_rank_block": 2 * n,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    for name, fn in (("all_gather_list", gather_list),
                     ("all_gather_into_tensor", gather_tensor),
                     ("all_reduce_whole", reduce_all),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("host_all_gather_into_tensor", host_gather),
                     ("host_reduce_scatter_tensor", host_reduce_scatter)):
        try:
            torch.cuda.synchronize(); dist.barrier()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            first = (time.perf_counter() - t) * 1e3
            fn()
            torch.cuda.synchronize(); dist.barrier()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) / reps * 1e3
            res[name] = dict(ms=ms, gb_per_s=4 * n / ms / 1e6,
                             first_ms=first)
        except Exception as e:  # gloo refuses some calls on CUDA tensors
            res[name] = dict(error=repr(e)[:300])
        dist.barrier()
    if rank == 0:
        print("gloo-fsdp " + json.dumps(res), flush=True)


def rank_main(rank, port, args):
    torch.set_num_threads(4)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    if args.fsdp:
        fsdp(rank, args.elements, args.reps)
    else:
        decode_sum(rank)
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--elements", type=int, default=48 << 20)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    with socket.socket() as s:
        s.bind(("localhost", 0)); port = s.getsockname()[1]
    mp.start_processes(rank_main, args=(port, args), nprocs=2,
                       start_method="spawn")
