"""The ``--data-parallel`` lanes of ``batch`` and ``hashAnno``: genomes
fanned over threads, each with its own device and engine (the reference's
``kmers_cmd.py:194-226`` and ``hash_anno_cmd.py:157-186``).

On ``cuda`` a lane is a visible card, made current in its thread; on the
CPU the lanes are threads sharing the host, the counterpart of the
reference's virtual devices.  Every genome runs the single-device
pipeline, so outputs do not depend on the lanes.
"""

from __future__ import annotations

import contextlib
import threading

import torch


def lane_devices(device: torch.device, n: int,
                 jobs: int) -> list[torch.device]:
    """The devices of ``--data-parallel n`` over ``jobs`` jobs: one lane a
    visible card on ``cuda``, ``min(n, cards, jobs)`` of them; ``min(n,
    jobs)`` lanes on the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(min(n, torch.cuda.device_count(), jobs))]
    return [device] * min(n, jobs)


def run_lanes(devs: list[torch.device], lane) -> None:
    """Run ``lane(i)`` for every lane in a thread of its own, with lane
    i's card current there, and wait for all of them; the first lane's
    exception is raised again here."""
    errors: list[BaseException] = []

    def worker(i: int) -> None:
        try:
            with (torch.cuda.device(devs[i]) if devs[i].type == "cuda"
                  else contextlib.nullcontext()):
                lane(i)
        except BaseException as exc:  # surfaced to the main thread
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(devs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
