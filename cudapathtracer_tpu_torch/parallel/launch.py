"""Start a group's ranks on this host, each a process of its own.

``start_ranks`` runs a function of a Python file in every rank: the rank
joins the group through ``initialize_distributed`` (a 60 s rendezvous and
collective timeout), calls ``fn(mesh, out_dir, *args)`` and saves the dict
of arrays it returns to ``<out_dir>/rank<r>.npz``; the caller waits for the
ranks and reads those back. The tests' spawned ranks and the smoke run's two
ranks on one card start this way. A rank is

    python -m cudapathtracer_tpu_torch.parallel.launch <file> <function> \\
        <init_method> <world> <rank> <out_dir> <device> <backend> <json args>

with an empty <backend> for the device's default.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANK_TIMEOUT = timedelta(seconds=60)


def free_port() -> int:
    """A free TCP port on this host, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(file, function, world, out_dir, device="cuda",
                backend=None, args=(), env=None, timeout=300):
    """Start ``world`` ranks, each running ``function`` of ``file`` on
    ``device`` over ``backend`` (None: ``initialize_distributed``'s choice,
    NCCL on a card and gloo on the CPU) with the JSON-able ``args``;
    ``env``: more environment for the ranks. The ranks' output goes to
    this process's.
    -> ``wait()``, which waits for them, kills every rank and raises if one
    fails or the ranks outlast ``timeout`` seconds, and otherwise returns
    each rank's dict of arrays in rank order. NCCL takes one card a rank:
    more NCCL ranks than cards, or than the one card ``device`` names,
    raise before any rank starts."""
    import torch

    dev = torch.device(device)
    if (backend or ("nccl" if dev.type == "cuda" else "gloo")) == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        have = (f"{cards} are present" if dev.index is None
                else f"{device} names one")
        if world > (cards if dev.index is None else 1):
            raise RuntimeError(
                f"{world} NCCL ranks need a card each, and {have}; NCCL "
                "refuses two ranks on one card (backend='gloo' shares one)")
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", __name__, os.path.abspath(file), function,
         init, str(world), str(r), str(out_dir), str(device), backend or "",
         json.dumps(list(args))], env=env) for r in range(world)]

    def wait():
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the ranks outlasted {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} failed (rc {p.returncode})")
        out = []
        for r in range(world):
            with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out

    return wait


def main(argv=None):
    import torch.distributed as dist

    from .mesh import initialize_distributed

    file, function, init, world, rank, out_dir, device, backend, args = (
        sys.argv[1:] if argv is None else argv)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(file))[0], file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    mesh = initialize_distributed(backend=backend or None, init_method=init,
                                  world_size=int(world), rank=int(rank),
                                  device=device, timeout=RANK_TIMEOUT)
    try:
        out = getattr(module, function)(mesh, out_dir, *json.loads(args))
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
