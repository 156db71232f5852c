"""Two trees of the port, in turns, on the bare dygraph train loop.

Each run is a fresh process started in its tree (so it imports that
tree's ``paddle_tpu_torch`` and builds that tree's kernels): GPT-2-small
widths, all 12 layers, ``AdamW(6e-4, weight_decay=0.1)``, one seeded
``[8, 1024]`` batch repeated for 6 steps (``loss.backward(); opt.step();
opt.clear_grad()``), in f32 and with the forward under
``amp.auto_cast(dtype="bfloat16")``; TF32 off.  Each run reports the
losses, the host step times (each step ends in the loss read), SHA-256
digests of the first step's gradients, of the weights after it and of
the weights after the last step, so two runs of one tree show whether
the loop is deterministic and two trees where their arithmetic parts.
It also reports ``opt_only``: the weights' digest of AdamW alone (8
tensors of 2^20, seeded gradients, 6 steps) under each rule variant;
and ``division_vs_host_float``: how many of 2^20 f32 entries times 12
bias corrections differ between dividing by a host Python float and
each other way of applying the correction on the card.

The variants replace the second tree's AdamW rule: ``host`` reads every
scalar on the host as a Python float (as the parent's Adam had them);
``host_lr``, ``host_keep`` (the decoupled decay factor) and ``host_bc``
(the bias corrections) read one of them so, the others staying 0-d
float64 device tensors; ``reciprocal`` multiplies by the f32
reciprocals of the device bias corrections.  Runs named
``change_<variant>`` drive the model under that variant.

Usage (on a card; a run takes 30-110 s, its tree's first build
included):

    python tools/torch_train_ab.py PARENT_TREE CHANGE_TREE \\
        [--order parent,change,change,parent] \\
        [--out train_ab.json]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RUN = r'''
import hashlib, json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import GPTModel


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def adamw_rule(host_lr, host_keep, host_bc, reciprocal):
    # AdamW's rule with the chosen scalars read on the host (Python
    # floats, as the parent's Adam had them) or kept on the device
    def rule(self, p, g, accs, lr, step):
        b1, b2, eps, wd = self._beta1, self._beta2, self._epsilon, self._wd
        lr_h, t = float(lr), float(step)
        keep = (1 - lr_h * wd) if host_keep else self._per_step(
            "keep", lambda: 1 - lr * wd)
        p = (p.float() * keep).to(p.dtype)
        gf = g.float()
        m = b1 * accs["moment1"].float() + (1 - b1) * gf
        v = b2 * accs["moment2"].float() + (1 - b2) * gf * gf
        if host_bc:
            mhat, vhat = m / (1 - b1 ** t), v / (1 - b2 ** t)
        elif reciprocal:
            mhat = m * self._per_step(
                "inv1", lambda: 1.0 / (1 - b1 ** step).float())
            vhat = v * self._per_step(
                "inv2", lambda: 1.0 / (1 - b2 ** step).float())
        else:
            mhat = m / self._per_step("bc1", lambda: 1 - b1 ** step)
            vhat = v / self._per_step("bc2", lambda: 1 - b2 ** step)
        new_p = (p.float() - (lr_h if host_lr else lr) * mhat
                 / (torch.sqrt(vhat) + eps)).to(p.dtype)
        return new_p, {"moment1": m.to(accs["moment1"].dtype),
                       "moment2": v.to(accs["moment2"].dtype)}
    return rule


VARIANTS = {"reciprocal": (False, False, False, True),
            "host": (True, True, True, False),
            "host_lr": (True, False, False, False),
            "host_keep": (False, True, False, False),
            "host_bc": (False, False, True, False)}
NATIVE_RULE = AdamW.__dict__.get("_rule")


def use(variant):
    if variant == "native":
        if NATIVE_RULE is not None:
            AdamW._rule = NATIVE_RULE
    else:
        AdamW._rule = adamw_rule(*VARIANTS[variant])


def opt_only():
    # AdamW alone on 8 tensors of 2^20 with seeded gradients, 6 steps
    rng = np.random.RandomState(1)
    ps = [torch.tensor(rng.randn(1 << 20).astype(np.float32) * 0.02,
                       device="cuda", requires_grad=True) for _ in range(8)]
    grads = [[torch.tensor(rng.randn(1 << 20).astype(np.float32) * 1e-3,
                           device="cuda") for _ in ps] for _ in range(6)]
    opt = AdamW(6e-4, parameters=ps, weight_decay=0.1)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = g
        opt.step()
        opt.clear_grad()
    return digest(ps)


def division_probe():
    # entries of m / (a host Python float) that differ from each other
    # way of applying the bias corrections of steps 1-6 (beta 0.9, 0.999)
    m = torch.tensor(np.random.RandomState(2).randn(1 << 20).astype(
        np.float32) * 1e-3, device="cuda")
    ways = {
        "div_f32_device": lambda bc: m / torch.tensor(
            bc, dtype=torch.float32, device="cuda"),
        "div_f64_device": lambda bc: m / torch.tensor(
            bc, dtype=torch.float64, device="cuda"),
        "mul_f32_recip_of_f32": lambda bc: m * (1.0 / torch.tensor(
            bc, dtype=torch.float32, device="cuda")),
        "mul_f32_of_f64_recip": lambda bc: m * torch.tensor(
            1.0 / bc, dtype=torch.float32, device="cuda"),
        "mul_host_recip": lambda bc: m * (1.0 / bc),
        "f64_div_rounded": lambda bc: (m.double() / bc).float()}
    diff = {k: 0 for k in ways}
    for b in (0.9, 0.999):
        for t in range(1, 7):
            bc = 1 - b ** t
            want = m / bc
            for k, f in ways.items():
                diff[k] += int((f(bc) != want).sum())
    return diff


out = {"opt_only": {}, "division_vs_host_float": division_probe()}
for variant in (["native"] + (list(VARIANTS) if NATIVE_RULE is not None
                              else [])):
    use(variant)
    out["opt_only"][variant] = opt_only()
use(VARIANT)
CFG = dict(vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
           ffn_size=3072, max_seq_len=1024)
for amp_dtype in (None, "bfloat16"):
    model = GPTModel(**CFG, device="cuda", seed=1234)
    params = list(model.parameters())
    opt = AdamW(6e-4, parameters=params, weight_decay=0.1)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, CFG["vocab_size"], (8, 1025)).astype(np.int64)).cuda()
    x, y = ids[:, :-1], ids[:, 1:]
    losses, step_ms, first = [], [], {}
    for step in range(6):
        t0 = time.perf_counter()
        if amp_dtype is None:
            logits = model(x)
        else:
            with amp.auto_cast(dtype=amp_dtype):
                logits = model(x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1))
        loss.backward()
        if step == 0:
            first["grads_sha256"] = digest(p.grad for p in params)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            first["weights_sha256"] = digest(params)
    out[str(amp_dtype)] = {"losses": losses, "step_ms": step_ms,
                           "step1": first, "weights_sha256": digest(params)}
    del model, params, opt, logits, loss
    torch.cuda.empty_cache()
print("RESULT", json.dumps(out))
'''


def run(tree: str, variant: str) -> dict:
    t0 = time.time()
    code = f"VARIANT = {variant!r}\n" + RUN
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    res = (json.loads(lines[0][len("RESULT "):]) if lines
           else {"error": proc.stderr[-3000:]})
    res["wall_s"] = time.time() - t0
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order",
                    default="parent,change,change,parent")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    trees = {"parent": (args.parent, "native"),
             "change": (args.change, "native")}
    trees.update({f"change_{v}": (args.change, v) for v in (
        "reciprocal", "host", "host_lr", "host_keep", "host_bc")})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    report = {"card": card.strip(), "runs": []}
    for name in args.order.split(","):
        res = run(*trees[name])
        report["runs"].append({"tree": name, **res})
        print(name, json.dumps(res), flush=True)
    print(report["card"])
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if all("error" not in r for r in report["runs"]) else 1


if __name__ == "__main__":
    sys.exit(main())
