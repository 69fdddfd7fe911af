"""Readings, not a test: the f32 noise of the gradients that phases 12a
and 13a/b of ``chip_smoke.py`` hold against f64.

For the string-hash seed of this process (the synthetic lines of both
phases' batches seed from ``hash(author)``), build phase 12a's batch and
small line trainer on the CPU and run each stepping lesson (count, auto,
auto-gen, gen, disc) twice from one state: in f32, and with the port's
modules in f64 (``chip_smoke.line_lesson_grads``); then one step of
``cli/train_hwr``'s recognizer and of ``AutoTrainer`` on phase 13's
batch, the same way (``chip_smoke.pretrain_grads``).  Print, per step,
the worst leaf's relative L2 of the f32 gradient handed to the optimizer
against the f64 one, the leaf and its f64 norm (leaves whose f64
gradient is under 1e-6 of the largest left out, as ``grad_check`` leaves
them out), and the relative L2 over the tree of the no-step lesson's
two stashed gradients.  This gap is the term that ``chip_smoke.grad_check`` adds,
twice, to each limit.  Run:

    for s in $(seq 0 27); do PYTHONHASHSEED=$s JAX_PLATFORMS=cpu \\
        PYTHONPATH=.:tests python tests/torch_line_grad_noise.py; done
"""

import os

import torch

import chip_smoke as cs

torch.set_num_threads(2)


def main():
    batch = cs.line_small_batch()
    pairs = [(cs.line_lesson_grads(torch, batch, f64=False),
              cs.line_lesson_grads(torch, batch, f64=True))]
    pairs += [({what: cs.pretrain_grads(torch, what, f64=False)},
               {what: cs.pretrain_grads(torch, what, f64=True)})
              for what in ("train_hwr", "AutoTrainer")]
    s32, s64 = pairs[0][0].pop("stash"), pairs[0][1].pop("stash")
    row = {f"stash {k}": f"{cs._tree_rel_l2(s32[k], w):.2e}"
           for k, w in s64.items()}
    for g32, g64 in pairs:
        for lesson, ref in g64.items():
            scale = max(float(w.norm()) for w in ref.values())
            errs = [(float((g32[lesson][n] - w).norm() / w.norm()), n,
                     float(w.norm())) for n, w in ref.items()
                    if float(w.norm()) > 1e-6 * scale]
            e, n, norm = max(errs)
            row[lesson] = f"{e:.2e} ({n}, norm {norm:.3g})"
    print(os.environ.get("PYTHONHASHSEED"), row, flush=True)


if __name__ == "__main__":
    main()
