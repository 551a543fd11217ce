"""Run a function on the ranks of a gloo process group of fresh processes
(the port's sharded tests).  Not a test module: the tests import it."""
import multiprocessing


def _entry(fn, rank: int, world: int, store: str, args) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 300):
    """``fn(rank, world, *args)`` on ``world`` spawned processes joined in
    one gloo group (a file store under ``tmp_path``); fails unless every
    rank exits 0 within ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    store = tmp_path / f"store_{world}"
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(store), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} of {world} ranks still ran after {timeout}s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
