"""Tap: the burn-in training step of ``tpu_node_checker_torch.models.burnin``.

Records, for each run of ``train_steps`` in this process: the whole
initial state where the model draws it (the one-card state ``shard_state``
cuts this rank's shards from, copied at once, before any step updates it)
and the whole batch of tokens each step is given (before the step takes its
rows), as the inputs of three outputs:

* ``burnin_step``: the loss each step returned;
* ``burnin_grad``: the norm of each of this rank's parameters' first
  gradient as the optimizer got it (its first moment after one step, over
  1 - b1);
* ``burnin_update``: the norm of each of this rank's parameters' change
  over the steps, read after the last.

Each step is a ``probebench:workload_step`` range in the trace, and each
run that took steps adds to the capture's ``train`` list which model ran
(``MODEL``, the name of its ``probebench/work/<model>.py``), its
configuration as a dict, and its count of steps.
"""

import dataclasses
import time

MODULE = "tpu_node_checker_torch.models.burnin"
MODEL = "burnin"


def _norms(tensors):
    import torch

    return torch.stack([t.double().norm() for t in tensors])


def install(cap, burnin) -> None:
    initial = {}
    sessions = []

    def keep_state(out, args, kwargs):
        t = time.perf_counter()
        full = args[0] if args else kwargs["state"]
        initial["state"] = {k: v.detach().to("cpu", copy=True) for k, v in full.items()}
        cap.meta["hook_s"] += time.perf_counter() - t

    burnin.shard_state = cap.tap(burnin.shard_state, keep_state)

    make_train_step = burnin.make_train_step

    def make_train_step_tap(*args, **kwargs):
        step, init_fn = make_train_step(*args, **kwargs)
        given = cap.bound(make_train_step, args, kwargs)
        cfg = args[0] if args else kwargs["cfg"]
        session = {"cfg": dataclasses.asdict(cfg), "learning_rate": given["learning_rate"],
                   "tokens": None, "losses": []}
        sessions.append(session)

        def timed_step(model, opt, tokens):
            if session["tokens"] is None:
                t = time.perf_counter()
                names = {id(p): n for n, p in model.named_parameters()}
                session.update(tokens=tokens, state=initial.get("state"), model=model, opt=opt,
                               names=[names[id(p)] for p in opt.params],
                               start=[p.detach().clone() for p in opt.params])
                cap.meta["hook_s"] += time.perf_counter() - t
            with cap.annotate("workload_step"):
                loss = step(model, opt, tokens)
            session["losses"].append(loss)
            if len(session["losses"]) == 1:
                t = time.perf_counter()
                session["grad_norms"] = _norms(m / (1 - opt.b1) for m in opt.mu)
                cap.meta["hook_s"] += time.perf_counter() - t
            return loss

        return timed_step, init_fn

    burnin.make_train_step = make_train_step_tap

    def flush(session) -> None:
        if session["losses"]:
            cap.meta.setdefault("train", []).append(
                {"model": MODEL, "cfg": session["cfg"], "steps": len(session["losses"])})
        if session["tokens"] is None or session["state"] is None:
            return
        import numpy as np

        t = time.perf_counter()
        state, opt, model = session["state"], session["opt"], session["model"]
        inputs = np.concatenate(
            [v.numpy().astype(np.float32).reshape(-1) for v in state.values()]
            + [session["tokens"].detach().cpu().numpy().astype(np.float32).reshape(-1)])
        losses = np.array([float(x) for x in session["losses"]], dtype=np.float64)
        change = _norms(p.detach() - p0 for p, p0 in zip(opt.params, session["start"]))
        leaves = []
        for name, p in zip(session["names"], opt.params):
            split = [d for d, (a, b) in enumerate(zip(state[name].shape, p.shape)) if a != b]
            leaves.append([name, split[0] if split else -1])
        args = {**{k: v for k, v in session["cfg"].items() if isinstance(v, (int, float, str))},
                "learning_rate": session["learning_rate"],
                "state": [[k, list(v.shape)] for k, v in state.items()]}
        per_leaf = {**args, "steps": len(losses), "leaves": leaves,
                    "model_index": model.mp.index, "model_count": model.mp.count}
        grads = session["grad_norms"].cpu().numpy() if "grad_norms" in session else None
        change = change.cpu().numpy()
        cap.meta["hook_s"] += time.perf_counter() - t
        idx = cap.record("burnin_step", inputs, losses, args)
        if grads is not None:
            cap.record("burnin_grad", None, grads, per_leaf, idx=idx)
            cap.record("burnin_update", None, change, per_leaf, idx=idx)

    train_steps = burnin.train_steps

    def train_steps_tap(*args, **kwargs):
        first = len(sessions)
        try:
            return train_steps(*args, **kwargs)
        finally:
            for session in sessions[first:]:
                flush(session)
            del sessions[first:]

    burnin.train_steps = train_steps_tap
