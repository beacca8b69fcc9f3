"""Train + serve any assigned architecture at reduced (smoke) scale.

Run:  PYTHONPATH=src python -m repro_torch.examples.lm_smoke --arch zamba2-1.2b [--device cpu]

Runs a few train steps (loss must fall), then a prefill + 8 greedy decode
steps through the serve cache — the same step functions the multi-pod dry-run
lowers at full scale.
"""
import argparse

import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import adamw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b", choices=registry.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    b = registry.build(args.arch, smoke=True)
    cfg = b.cfg
    shape = ShapeCfg("smoke", "train", 64, 4)
    opt = adamw(3e-3)
    params = b.init(torch.Generator(device).manual_seed(0))
    opt_state = opt.init(params)
    step = b.train_step(None, opt, shape)

    losses = []
    for i in range(args.steps):
        batch = b.make_batch(shape, torch.Generator(device).manual_seed(i),
                             act_dtype=torch.float32)
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        print(f"step {i:2d} loss {losses[-1]:.4f}")
    if args.steps >= 8:  # too few steps is noise-dominated
        assert min(losses[3:]) < losses[0], "training must reduce loss"

    # prefill + decode
    pshape = ShapeCfg("p", "prefill", 32, 4)
    dshape = ShapeCfg("d", "decode", 40, 4)
    batch = b.make_batch(pshape, torch.Generator(device).manual_seed(99),
                         act_dtype=torch.float32)
    prefill = T.make_prefill_step(cfg, None, dshape)
    logits, cache = prefill(params, batch)
    serve = T.make_serve_step(cfg, None)
    toks = []
    for t in range(8):
        nxt = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
        toks.append(nxt)
        db = {"tokens": nxt[:, None]}
        if cfg.input_kind == "embeds":
            db = {
                "embeds": torch.zeros((4, 1, cfg.d_model), device=device),
                "positions": torch.full((3, 4, 1), int(cache["pos"]), dtype=torch.int32,
                                        device=device),
            }
        logits, cache = serve(params, cache, db)
    print("greedy tokens:", torch.stack(toks, 1)[0].tolist())
    print("OK")
    return losses


if __name__ == "__main__":
    main()
