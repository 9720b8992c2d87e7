"""Train the image->event contrastive bridge (paper Eq. 1-3).

Synthesizes paired (image-embedding, event-window) data for a small class
vocabulary, trains the spiking encoder against frozen CLIP-proxy targets
with L = L_con + alpha * L_zs and AdamW, and reports zero-shot accuracy —
the paper's training phase, miniaturized.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_bridge [--steps 150]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import bridge, encoder
from ..device import resolve_device
from ..optim import adamw

H = W = 16
T_BINS, EMB = 4, 64


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train, print the reference's log lines, raise unless the zero-shot
    accuracy of the last 10 steps beats the first 10 by more than 0.2.
    Returns ``first``, ``last``, ``accs``, ``step_s`` (each step's wall
    seconds, each ending in a host read of the metrics) and ``s_per_step``
    (their mean after the first step)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    ecfg = encoder.EncoderConfig(c1=8, c2=16, feat_dim=EMB)
    gen = torch.Generator().manual_seed(0)
    enc = encoder.init_encoder(ecfg, gen).to(dev)

    # frozen proxies: image encoder sees class "images"; text bank is fixed
    f_img = bridge.make_frozen_proxy(args.classes, EMB, generator=gen).to(dev)
    text_bank = torch.randn((args.classes, EMB), generator=gen).to(dev)

    # per-class event signature: a spatial blob whose events fire consistently
    rng = np.random.default_rng(0)
    centers = rng.integers(3, H - 3, (args.classes, 2))

    def sample_batch(step):
        r = np.random.default_rng(step)
        labels = r.integers(0, args.classes, args.batch)
        vols = np.zeros((args.batch, T_BINS, H, W, 2), np.float32)
        for i, c in enumerate(labels):
            cy, cx = centers[c]
            n_ev = 60
            ys = np.clip(r.normal(cy, 1.5, n_ev).astype(int), 0, H - 1)
            xs = np.clip(r.normal(cx, 1.5, n_ev).astype(int), 0, W - 1)
            tb = r.integers(0, T_BINS, n_ev)
            pol = (r.random(n_ev) < 0.5).astype(int)
            np.add.at(vols[i], (tb, ys, xs, pol), 1.0)
        labels = torch.from_numpy(labels).to(dev)
        img = torch.nn.functional.one_hot(labels, args.classes).float()
        return torch.from_numpy(vols).to(dev), f_img(img), labels

    ocfg = adamw.OptimConfig(lr=2e-3, warmup_steps=10, total_steps=args.steps,
                             weight_decay=0.01)
    params = dict(enc.named_parameters())
    opt = adamw.init_opt_state(params)

    accs, step_s = [], []
    for s in range(args.steps):
        t0 = time.perf_counter()
        vols, img_emb, labels = sample_batch(s)
        ev_emb = encoder.encode_batch(enc, vols, ecfg)
        loss, metrics = bridge.bridge_loss(img_emb, ev_emb, text_bank,
                                           labels, alpha=args.alpha)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        new, opt, _ = adamw.apply_updates(params, grads, opt, ocfg)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        accs.append(float(metrics["zs_acc"]))
        step_s.append(time.perf_counter() - t0)
        if s % 25 == 0 or s == args.steps - 1:
            print(f"step {s:4d}  L={loss.item():.3f}  "
                  f"L_con={float(metrics['l_con']):.3f} "
                  f"L_zs={float(metrics['l_zs']):.3f}  zs_acc={accs[-1]:.2f}")
    s_per_step = float(np.mean(step_s[1:] if args.steps > 1 else step_s))

    first, last = np.mean(accs[:10]), np.mean(accs[-10:])
    print(f"\nzero-shot accuracy: {first:.2f} -> {last:.2f}")
    if not last > first + 0.2:
        raise AssertionError("bridge did not learn")
    print("bridge converged ✓ (event features aligned to CLIP-proxy space)")
    return {"first": float(first), "last": float(last), "accs": accs,
            "step_s": step_s, "s_per_step": s_per_step, "device": str(dev)}


if __name__ == "__main__":
    main()
