"""Tap: DeepSeek-V2-Lite's training step, ``tpu_node_checker_torch.models.deepseek_v2``.

Records, for each run of ``train_steps`` in this process, what the
reference needs to train the same model again and what the timed path
produced, and no tensor of the state: the configuration, the learning rate,
the seed the weights were drawn from (by the module's written recipe) and
the kind of device they were drawn on, and the whole batch of tokens each
step is given, as the inputs of three outputs:

* ``dsv2_step``: the loss each step returned;
* ``dsv2_grad``: the norm of each parameter's first gradient as the
  optimizer got it (its first moment after one step, over 1 - b1);
* ``dsv2_update``: the norm of each parameter's change over the steps,
  read after the last against the initial leaf drawn again by the recipe,
  one leaf at a time;
* ``dsv2_router``: the router's logits (``parallel.moe.router_logits``)
  at the first MoE layer of the first step, at ``ROUTER_ROWS`` tokens drawn from ``PROBEBENCH_SEED``, with
  those tokens' hidden states and the router's weight as its inputs (the
  steps' outputs cannot tell the router's precision from the activations').

Each step is a ``probebench:workload_step`` range in the trace, and each
run that took steps adds to the capture's ``train`` list which model ran
(``MODEL``, the name of its ``probebench/work/<model>.py``), its
configuration as a dict, and its count of steps.
"""

import dataclasses
import time

MODULE = "tpu_node_checker_torch.models.deepseek_v2"
MODEL = "deepseek_v2_lite"
ROUTER_ROWS = 256


def _norm64(t) -> float:
    import torch

    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def install(cap, dsv2) -> None:
    sessions = []
    make_train_step = dsv2.make_train_step

    def make_train_step_tap(*args, **kwargs):
        step, init_fn = make_train_step(*args, **kwargs)
        given = cap.bound(make_train_step, args, kwargs)
        cfg = args[0] if args else kwargs["cfg"]
        session = {"cfg": cfg, "learning_rate": given["learning_rate"], "seed": None,
                   "tokens": None, "losses": []}
        sessions.append(session)

        def init_tap(*a, **kw):
            model, opt = init_fn(*a, **kw)
            session.update(seed=cap.bound(init_fn, a, kw)["seed"], model=model, opt=opt)
            return model, opt

        def timed_step(model, opt, tokens):
            if session["tokens"] is None:
                t = time.perf_counter()
                session["tokens"] = tokens.detach().cpu()
                cap.meta["hook_s"] += time.perf_counter() - t
            with cap.annotate("workload_step"):
                loss = step(model, opt, tokens)
            session["losses"].append(loss)
            if len(session["losses"]) == 1:
                t = time.perf_counter()
                session["grad_norms"] = [_norm64(m) / (1 - opt.b1) for m in opt.mu]
                cap.meta["hook_s"] += time.perf_counter() - t
            return loss

        return timed_step, init_tap

    dsv2.make_train_step = make_train_step_tap

    router_logits = dsv2.moe.router_logits

    def router_tap(x, w):
        logits = router_logits(x, w)
        session = sessions[-1] if sessions else None
        if session is not None and session["losses"] == [] and "router" not in session:
            import numpy as np
            import torch

            t = time.perf_counter()
            rng = np.random.default_rng([cap.seed, x.shape[0], ROUTER_ROWS])
            rows = rng.choice(x.shape[0], size=min(ROUTER_ROWS, x.shape[0]), replace=False)
            pick = torch.from_numpy(rows).to(x.device)
            session["router"] = (
                np.concatenate([x[pick].float().cpu().numpy().reshape(-1),
                                w.detach().float().cpu().numpy().reshape(-1)]),
                logits[pick].detach().float().cpu().numpy(),
                {"rows": len(rows), "hidden": x.shape[1], "experts": w.shape[1]})
            cap.meta["hook_s"] += time.perf_counter() - t
        return logits

    dsv2.moe.router_logits = router_tap

    def flush(session) -> None:
        cfg = dataclasses.asdict(session["cfg"])
        if session["losses"]:
            cap.meta.setdefault("train", []).append(
                {"model": MODEL, "cfg": cfg, "steps": len(session["losses"])})
        if session["tokens"] is None or "grad_norms" not in session:
            return
        import numpy as np

        t = time.perf_counter()
        model = session["model"]
        device = model.embed.device
        names, change = [], []
        params = dict(model.named_parameters())
        for name, p0 in dsv2.draw_state(session["cfg"], session["seed"], device):
            names.append(name)
            change.append(_norm64(params[name].detach() - p0))
            del p0
        losses = np.array([float(x) for x in session["losses"]], dtype=np.float64)
        args = {"cfg": cfg, "seed": session["seed"], "learning_rate": session["learning_rate"],
                "draw_device": device.type}
        per_leaf = {**args, "steps": len(losses), "leaves": names}
        inputs = session["tokens"].numpy().astype(np.float32).reshape(-1)
        cap.meta["hook_s"] += time.perf_counter() - t
        idx = cap.record("dsv2_step", inputs, losses, args)
        cap.record("dsv2_grad", None, np.array(session["grad_norms"]), per_leaf, idx=idx)
        cap.record("dsv2_update", None, np.array(change), per_leaf, idx=idx)
        if "router" in session:
            inputs, logits, shape = session["router"]
            cap.record("dsv2_router", inputs, logits, shape)

    train_steps = dsv2.train_steps

    def train_steps_tap(*args, **kwargs):
        first = len(sessions)
        try:
            return train_steps(*args, **kwargs)
        finally:
            for session in sessions[first:]:
                flush(session)
            del sessions[first:]

    dsv2.train_steps = train_steps_tap
