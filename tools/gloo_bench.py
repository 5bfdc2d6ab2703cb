"""Latency of a gloo all-reduce between 2 ranks sharing one card, at the
size of a tensor-parallel StarCoder2-3B decode step's row-parallel sum
((8, 1, 3,072) fp32): a CUDA tensor handed to gloo, the same staged
through the host by hand (pageable, then pinned), and a host tensor
alone; 1,000 calls each after 50 warm-up calls, ms a call printed by
rank 0.  Run on a machine with a GPU:

    python3 tools/gloo_bench.py
"""
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, port):
    torch.set_num_threads(4)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
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
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0)); port = s.getsockname()[1]
    mp.start_processes(rank_main, args=(port,), nprocs=2,
                       start_method="spawn")
