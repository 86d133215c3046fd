"""Whether NCCL takes several ranks on one card, and across the cards.

    python -m tf_flash_attention_tpu_torch.utils.nccl_ranks [--ranks N] [--cards] [--timeout S]

Spawns ``N`` processes (2 by default).  By default every one is on
``cuda:0`` (the shared-card mode: NCCL 2.28.9 refuses it, "Duplicate GPU
detected"); with ``--cards`` rank k is on ``cuda:k`` (the across-cards
mode, N at most the cards there are).  Each rank makes its card current,
joins an NCCL process group (``tcp://127.0.0.1``, a free port), runs one
``all_reduce`` of its rank and one ring exchange (``batch_isend_irecv``:
its rank to the next rank, the previous rank's from it).  Prints one JSON
line: the NCCL version, the mode, and each rank's outcome, the sum and
the value it received or the first line of its error; a rank that has
not ended within ``S`` seconds is killed and reported so.  Exits 0
whatever the ranks did: the outcome is the finding.
"""

import argparse
import json
import os
import queue
import socket

import torch
import torch.multiprocessing as mp


def _rank(rank, world, port, cards, out):
    import datetime

    import torch.distributed as dist

    dev = torch.device("cuda", rank if cards else 0)
    torch.cuda.set_device(dev)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
        x = torch.full((4,), float(rank), device=dev)
        dist.all_reduce(x)
        got = torch.empty(4, device=dev)
        mine = torch.full((4,), float(rank), device=dev)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, (rank + 1) % world),
                                           dist.P2POp(dist.irecv, got, (rank - 1) % world)]):
            req.wait()
        torch.cuda.synchronize()
        out.put((rank, {"device": str(dev), "sum": x.tolist(), "received": got.tolist()}))
    except Exception as e:   # the error is the outcome this tool reports
        out.put((rank, {"device": str(dev),
                        "error": f"{type(e).__name__}: {str(e).strip().splitlines()[0]}",
                        "message": str(e)[:2000]}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cards", action="store_true",
                    help="rank k on cuda:k (default: every rank on cuda:0)")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on the GPU")
    if args.cards and args.ranks > torch.cuda.device_count():
        raise SystemExit(f"--cards puts a rank on each card: {args.ranks} ranks, "
                         f"{torch.cuda.device_count()} cards")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, args.ranks, port, args.cards, out))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    ranks = {}
    try:
        for _ in procs:
            rank, outcome = out.get(timeout=args.timeout)
            ranks[rank] = outcome
    except queue.Empty:
        pass
    for r, p in enumerate(procs):
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
            ranks.setdefault(r, {"error": f"no outcome within {args.timeout} s: killed"})
        ranks[r]["exitcode"] = p.exitcode
    print(json.dumps({"nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "torch": torch.__version__, "device": torch.cuda.get_device_name(0),
                      "mode": "rank k on cuda:k" if args.cards else "every rank on cuda:0",
                      "ranks": args.ranks, "outcomes": {r: ranks[r] for r in sorted(ranks)}}))


if __name__ == "__main__":
    main()
