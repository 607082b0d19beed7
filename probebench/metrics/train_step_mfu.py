"""train_step_mfu: a one-card training step's model FLOPs over its card time at the card's peak, in %.

The step's model FLOPs come from ``probebench/work/<model>.py``'s
``step_flops(cfg)``, for the model and configuration the training tap
recorded in the round's captures (``train``), by the convention written in
``work/burnin.py``.  The time is ``train_step_card_ms``, at the card's
dense bf16 peak (``roofline.PEAKS``), the precision the configuration
states.  Nothing where a window round trained in no process or in more
than one (a step sharded over cards), where the rounds trained more than
one model or configuration, where the model has no ``work/`` file, where
the card has no peak in the table, or where the step time reads nothing.
"""

import importlib.util
import json

from probebench import roofline
from probebench.core import HERE, load_reader

card_ms = load_reader("train_step_card_ms")


def step_flops(model: str, cfg: dict):
    """``work/<model>.py``'s count for ``cfg``, or None without that file."""
    path = HERE / "work" / f"{model}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(f"probebench_work_{model}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.step_flops(cfg)


def read(run):
    peak = roofline.peaks(run.device_kind)
    ms = card_ms(run)
    if peak is None or ms is None:
        return None
    trained = set()
    for r in run.rounds:
        procs = [p["capture"]["train"] for p in run.processes(r)
                 if (p["capture"] or {}).get("train")]
        if len(procs) != 1:
            return None
        trained |= {(t["model"], json.dumps(t["cfg"], sort_keys=True)) for t in procs[0]}
    if len(trained) != 1:
        return None
    model, cfg = trained.pop()
    flops = step_flops(model, json.loads(cfg))
    return None if flops is None else 100.0 * flops / (ms / 1e3 * peak["bf16_flops"])
