"""What NCCL does with two ranks on one card.

Spawns two processes that both take ``cuda:0``, initialise an NCCL
process group and all-reduce one tensor, and prints one JSON line per
rank: the all-reduce's result, or the error it raised (NCCL refuses two
ranks on one device, "Duplicate GPU detected"). A rank that hangs is
killed after ``--timeout`` seconds and reported so. The port's mesh runs
on one card therefore use gloo for two ranks (``chip_smoke.py`` phase
12) and NCCL only for a 1 x 1 mesh. Run on a machine with a card:

    python3 scripts/nccl_two_ranks.py
"""

import argparse
import json
import multiprocessing
import queue
import socket
import subprocess


def rank_main(rank: int, port: int, out) -> None:
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", rank=rank, world_size=2,
                                init_method=f"tcp://127.0.0.1:{port}")
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out.put({"rank": rank, "ok": True, "result": t.tolist()})
    except Exception as e:  # noqa: BLE001 — the finding itself
        out.put({"rank": rank, "ok": False,
                 "error": f"{type(e).__name__}: {e}"[:2000]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=90.0)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    reports = {}
    for _ in procs:
        try:
            r = out.get(timeout=args.timeout)
            reports[r["rank"]] = r
        except queue.Empty:  # a rank hangs
            break
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()
    for rank in range(2):
        print(json.dumps({**reports.get(rank, {
            "rank": rank, "ok": False,
            "error": f"no report within {args.timeout} s (killed)"}),
            "exitcode": procs[rank].exitcode, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
