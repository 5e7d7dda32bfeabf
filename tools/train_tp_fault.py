#!/usr/bin/env python3
"""Read ``chip_smoke.py``'s ``train_tp`` tolerances against a planted fault.

    python3 tools/train_tp_fault.py

Runs, on one card, the one-device ``train`` phase (its record of the
first steps: losses, gradient norms, gradient histories, masks and block
scores), then ``train_tp`` with its checks, then ``train_tp``'s ranks
again with ``DistContext.sum_over_model`` planted as a no-op: under
sequence parallelism (the default) the norms' scales act on each rank's
S shard, and their gradients then stay partial sums. Prints the phases'
JSON lines and, last, the planted run's distances from the one-device
record (``_train_tp_readings``) and its (b) update errors: the upper
readings that the tolerances ``TRAIN_TP_TOL`` and ``TRAIN_TP_LAYER_TOL``
sit below, the correct run's being the lower ones. (Before sequence
parallelism the planted fault was ``copy_to_model`` as the identity;
under it the column-parallel inputs pass ``gather_from_seq`` instead.)
Needs a CUDA card (the ranks share card 0 over gloo) and about 80 GB of
it.
"""
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def faulty(rank, *a):
    """A ``train_tp`` rank whose norms' partial gradients stay unsummed."""
    from repro_torch.distributed import context
    context.DistContext.sum_over_model = lambda self, grads: None
    cs._train_tp_rank(rank, *a)


def main():
    import torch
    from repro_torch.configs.paper_models import LLAMA32_1B
    cs.phase_env(torch)
    tcfg, opt, src, state, ref = cs.phase_train(torch, LLAMA32_1B)
    del state
    torch.cuda.empty_cache()
    tp = cs._train_tp_start(torch, tcfg, opt, src)
    cs.phase_train_tp(torch, tcfg, opt, src, ref, tp)
    t0 = time.monotonic()
    go = multiprocessing.get_context("spawn").Event()
    procs = cs._start_ranks(cs.TRAIN_TP_DIR, faulty, 2,
                            (2, "gloo", tcfg, opt, src, go))
    go.set()
    ranks = cs._join_ranks("train_tp_fault", cs.TRAIN_TP_DIR, procs)
    r = cs._train_tp_readings(torch, ranks, ref)
    print(json.dumps({"planted": "sum_over_model no-op",
                      "loss": r["loss"], "grad_norm": r["grad_norm"],
                      "history": r["history"], "history_at": r["history_at"],
                      "masks_differing": len(r["differing"]),
                      "b_update_err": [s["update_err"] for s in
                                       ranks[0]["b"]["steps"]],
                      "s": time.monotonic() - t0}), flush=True)


if __name__ == "__main__":
    main()
