"""train_step_card_ms: device milliseconds of one training step, on the busiest card.

What a step launched on the card: in each process of a window round, the
union of the kernels, copies and fills launched inside the training tap's
``probebench:workload_step`` ranges (forward, backward, the optimizer's
update; matched to each launch by correlation id), NCCL's kernels left
out, over the count of steps; the busiest card of the round, the mean over
the window's rounds.  It is ``step_card_ms.workload``'s reading, one
formula in that file, taken where the step is the cell's end-to-end
metric: a one-card round spawns no rank, so ``workload_card_ms`` reads
nothing there.  Nothing where a round's trace holds no step.
"""

from probebench.core import load_reader

read = load_reader("step_card_ms.workload")
