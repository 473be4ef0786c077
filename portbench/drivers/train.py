"""Training driver: the port's training step (``train/step.py``'s
``make_train_step`` with AdamW and the mix's schedule, as ``run_training``
builds it), fed packed batches drawn from the seed.

Set-up builds one train state (the seeded model, ``optimizer.init``'s
moments: ``make_train_state``'s state with the benchmark's weights) and
drives it through steps 1-3 by the window's own call and feed.  Those
steps are the checked ones: after step 1 each leaf's gradient as the
optimizer took it is read back from its first moment (m = (1 - b1) g),
after step 3 each leaf's change from the seeded start; step 4 onwards is
the window.  Then the state is freed and the plain reference trains from
the same weights on the same three batches.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

from .. import port, reference, trace
from ..faults import planted, wrap_train_step
from ..gen import PackedDocs
from ..weights import draw_group, leaf_names

__all__ = ["run"]

CHECKED_STEPS = 3
TINY_GRAD = 1e-3        # leaves whose reference gradient is below this share of the median's


def _readings(prog: Dict, ref: Dict):
    """Step 1's loss gap, the median and the worst leaf's gap of the first
    gradient's norm, the worst leaf's gap of the change's norm, and the
    worst of the checked steps' loss gaps; and a line that says which steps
    and leaves."""
    ordered = sorted(ref["grad"].values())
    median = ordered[len(ordered) // 2]
    tiny = {n for n, g in ref["grad"].items() if g < TINY_GRAD * median}
    gaps = [abs(a - b) for a, b in zip(prog["loss"], ref["loss"])]
    grad = reference.leaf_gaps(prog["grad"], ref["grad"])
    change = reference.leaf_gaps(prog["change"], ref["change"], skip=tiny.__contains__)
    grad_leaf, change_leaf = max(grad, key=grad.get), max(change, key=change.get)
    detail = (f"losses {prog['loss']!r} against {ref['loss']!r}; worst gradient leaf "
              f"{grad_leaf}, worst change leaf {change_leaf}; {len(tiny)} leaves left out of "
              f"the change (reference gradient under {TINY_GRAD} of the median leaf's)")
    return {"loss_gap_step1": gaps[0], "grad_gap_median": statistics.median(grad.values()),
            "grad_gap": grad[grad_leaf], "change_gap": change[change_leaf],
            "loss_gap": max(gaps)}, detail


def _reference(ctx, feed: PackedDocs, quant=None) -> Dict:
    import torch
    ref = reference.TrainReference(ctx.family, ctx.spec, ctx.seed, ctx.traffic["optimizer"],
                                   ctx.device, quant=quant)
    out: Dict = {"loss": []}
    for k in range(1, CHECKED_STEPS + 1):
        b = {n: torch.from_numpy(v).to(ctx.device) for n, v in feed.batch(k).items()}
        loss, norms = ref.step(b["tokens"], b["labels"])
        out["loss"].append(loss)
        if k == 1:
            out["grad"] = norms
    out["change"] = ref.change_norms(ctx.seed, ctx.device)
    del ref
    gc.collect()
    ctx.free()
    return out


def run(ctx) -> Dict:
    import torch
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.step import make_train_step
    fam, s, mix = ctx.family, ctx.spec, ctx.traffic
    o = mix["optimizer"]
    record: Dict = {"spec": s, "family": ctx.cfg["family"], "rows": int(mix["rows"]),
                    "seq": int(mix["seq"]),
                    "tokens_per_step": int(mix["rows"]) * int(mix["seq"])}
    feed = PackedDocs(mix, s.vocab, int(ctx.cfg["eos_token_id"]), ctx.seed)
    with planted(fam, ctx.fault):
        arch = fam.arch_config(ctx.cfg, s, ctx.config_name)
        ctx.mark("imported")
        model = port.load_model(fam, arch, s, ctx.seed, ctx.device, requires_grad=True)
        ctx.sync()
        ctx.mark("weights")
        optimizer = AdamW(lr=warmup_cosine(o["lr"], o["warmup"], o["total_steps"], o["floor"]),
                          b1=o["b1"], b2=o["b2"], eps=o["eps"],
                          weight_decay=o["weight_decay"], grad_clip=o["grad_clip"])
        state = {"params": model, "opt": optimizer.init(model)}
        step_fn = wrap_train_step(fam, ctx.fault, make_train_step(arch, optimizer,
                                                                  remat=mix["remat"]))

        def one(k: int) -> float:
            nonlocal state
            batch = {n: torch.from_numpy(v).to(ctx.device) for n, v in feed.batch(k).items()}
            state, metrics = step_fn(state, batch)
            return float(metrics["loss"])

        prog: Dict = {"loss": [one(1)]}
        with torch.no_grad():
            prog["grad"] = {n: float(torch.linalg.vector_norm(m)) / (1 - o["b1"])
                            for n, m in state["opt"].m.items()}
        ctx.mark("step 1")
        prog["loss"] += [one(k) for k in range(2, CHECKED_STEPS + 1)]
        params = dict(model.named_parameters())
        prog["change"] = {}
        with torch.no_grad():
            for g in fam.groups(s):
                start = draw_group(fam, s, ctx.seed, g, ctx.device)
                for n in leaf_names(fam, s, g):
                    prog["change"][n] = float(torch.linalg.vector_norm(
                        params[n].float() - start[n].float()))
            del start
        ctx.sync()

        steps = []
        k = CHECKED_STEPS + 1
        gc.collect()
        gc.freeze()      # set-up's objects out of the collector's way in the window
        t_open = time.perf_counter()
        while True:
            loss = one(k)
            k += 1
            t = time.perf_counter()
            steps.append({"t": t, "loss": loss})
            if t - t_open >= ctx.seconds:
                break
        if ctx.trace:
            for key, host_ops in (("trace", False), ("trace_ops", True)):
                with trace.traced(record, key, host_ops):
                    for _ in range(int(mix["trace_steps"])):
                        one(k)
                        k += 1
        record["memory_peak_bytes"] = ctx.memory_peak()
        ctx.mark("window and trace done")
        record.update(window={"open": t_open, "close": steps[-1]["t"],
                              "seconds": steps[-1]["t"] - t_open},
                      steps=steps, trace_steps=int(mix["trace_steps"]) if ctx.trace else 0,
                      attempted=len(steps),
                      failed=sum(not (x["loss"] == x["loss"]) for x in steps))
        del state, model, optimizer, params, step_fn
    gc.unfreeze()
    gc.collect()
    ctx.free()

    ref = _reference(ctx, feed)
    ctx.mark("reference done")
    record["readings"], detail = _readings(prog, ref)
    record.setdefault("bases", []).append("checked steps: " + detail)
    if ctx.control:
        record["control"], detail = _readings(_reference(ctx, feed, quant="fp8"), ref)
        record["bases"].append("control: " + detail)
        ctx.mark("control done")
    return record
