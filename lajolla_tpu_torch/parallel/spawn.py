"""Run a function on R ranks of one machine, each in its own process.

    results = spawn(fn, R, *args, backend='gloo', timeout=600)

calls fn(group, *args) on ranks 0 .. R-1 and returns their results in
rank order. The tests run the sharded renders this way on the CPU, and
chip_smoke.py on the card; a multi-GPU user starts one process a GPU with
`torchrun --nproc_per_node=R` instead (mesh.default_group).

- The ranks are `spawn` processes, each with one intra-op torch thread,
  that meet at a file:// rendezvous in a temporary directory: a TCP port
  would collide between test processes running side by side.
- fn and args go to the ranks through a file written with torch.save
  (fn by its import path, so it lives in an importable module); each
  rank writes its result the same way, and the parent loads them onto the
  CPU. Build the CUDA kernels (kernels.build) before spawning: the ranks
  then load them instead of running nvcc each.
- A rank that exits non-zero makes spawn raise with that rank's traceback,
  and ranks still running after `timeout` seconds make it raise
  TimeoutError; either way every rank is killed before spawn returns.
"""

import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback

import torch


def _rank_main(rank, nprocs, backend, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        fn, args = torch.load(os.path.join(tmp, 'args.pt'),
                              weights_only=False)
        dist.init_process_group(
            backend, init_method='file://' + os.path.join(tmp, 'rendezvous'),
            rank=rank, world_size=nprocs)
        try:
            out = fn(dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f'rank{rank}.pt'))
    except BaseException:
        with open(os.path.join(tmp, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def _traceback(tmp, rank):
    path = os.path.join(tmp, f'rank{rank}.err')
    if not os.path.exists(path):
        return '(no traceback)'
    with open(path) as f:
        return f.read()


def spawn(fn, nprocs, *args, backend='gloo', timeout=600.0):
    """fn(group, *args) on `nprocs` ranks of a `backend` process group →
    [rank 0's result, ...]. Raises if a rank fails or outlasts `timeout`
    seconds."""
    ctx = multiprocessing.get_context('spawn')
    with tempfile.TemporaryDirectory(prefix='lajolla_ranks_') as tmp:
        torch.save((fn, args), os.path.join(tmp, 'args.pt'))
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nprocs, backend, tmp), daemon=True)
                 for r in range(nprocs)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {[procs.index(p) for p in running]} of "
                        f"{nprocs} still running after {timeout} s")
                multiprocessing.connection.wait([p.sentinel for p in running],
                                                left)
                for p in [p for p in running if p.exitcode is not None]:
                    running.remove(p)
                    if p.exitcode != 0:
                        r = procs.index(p)
                        raise RuntimeError(f"rank {r} of {nprocs} exited "
                                           f"with {p.exitcode}:\n"
                                           f"{_traceback(tmp, r)}")
            return [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                               map_location='cpu', weights_only=False)
                    for r in range(nprocs)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join()
