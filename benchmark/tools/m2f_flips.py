"""Where the Mask2Former cell's score gaps come from. For each seed, the
checked frames of the pool's sessions (the cell's own set-up: rooms,
weights drawn from the seed), one resized input handed to each side, go
through the program's model and through the plain reference in float32 and
in the float8 control. For each decoder layer, the share of attention-mask
entries (query x key) that differ from the float32 reference's; beside it
the scores' largest and relative L1 gaps and the pixel decoder's mask
features' relative L1 gap, and those of the program run again with the
reference's attention masks put in place of its own (its flips then
counted on the masks it computed, not those it used).

    python3 benchmark/tools/m2f_flips.py --seeds 1,2,3 [--sessions 2] [--out FILE]

Prints one JSON line per seed and appends them to --out when given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1])]

from f3sbench import core  # noqa: E402

CELL = "scan-m2f-swinl-tum640"


def _reference_masks(mask2former_ref):
    class Recording(mask2former_ref.Mask2FormerRef):
        """The reference, recording each masked cross-attention's mask as
        the program's `keep` [B, Q, keys]: True where a query attends."""

        def mha(self, q, k, v, pre, mask=None):
            if mask is not None:
                self.keeps.append(~mask[:, 0])
            return super().mha(q, k, v, pre, mask)

    return Recording


def readings(seeds, sessions: int = 2, device: str = "cuda", overrides=None, log=core.log):
    import torch
    import torch.nn.functional as F

    from reference import mask2former_ref

    Recording = _reference_masks(mask2former_ref)
    spec, entry, config, traffic, driver = core.load_cell(CELL)
    for k, v in (overrides or {}).items():
        (config if k in config else traffic)[k] = v
    seg = config["segmenter"]
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        st = driver.setup(core.Ctx(entry, config, traffic, seed, torch.device(device)))
        model = st.segmenter.model
        params = {k: v.to(st.dev) for k, v in st.params.items()}
        ref32 = Recording(params, seg, "float32")
        ref8 = Recording(params, seg, "fp8")
        row = {"cell": CELL, "seed": seed}
        sums = {}

        def control(x):
            ref8.keeps = []
            return (*ref8(x, with_features=True), ref8.keeps)

        for k in range(min(sessions, len(st.sessions))):
            rgb = st.sessions[k]["rgb"][st.check_frames]
            for a in range(0, len(rgb), seg["batch"]):
                x = torch.as_tensor(rgb[a:a + seg["batch"]], device=st.dev).float() / 255.0
                x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(seg["input_hw"]),
                                  mode="bilinear", align_corners=False)
                x = x.permute(0, 2, 3, 1).contiguous()
                ref32.keeps = []
                want, wfeat = ref32(x, with_features=True)
                rk = ref32.keeps
                den = float(want.double().abs().sum())
                fden = float(wfeat.double().abs().sum())
                for side, got, feat, keeps in (("control", *control(x)),
                                               ("program", *_program(model, x, None)),
                                               ("imposed", *_program(model, x, rk))):
                    d = (got - want).abs()
                    s = sums.setdefault(side, {"max_gap": 0.0, "num": 0.0, "den": 0.0,
                                               "fnum": 0.0, "fden": 0.0,
                                               "flips": [0] * len(rk), "entries": [0] * len(rk)})
                    s["max_gap"] = max(s["max_gap"], float(d.amax()))
                    s["num"] += float(d.double().sum())
                    s["den"] += den
                    s["fnum"] += float((feat.float() - wfeat).abs().double().sum())
                    s["fden"] += fden
                    for j, (g, r) in enumerate(zip(keeps, rk)):
                        s["flips"][j] += int((g != r).sum())
                        s["entries"][j] += r.numel()
                    del got, feat, keeps, d
                del want, wfeat, rk
        for side, s in sums.items():
            row[side] = {"max_gap": s["max_gap"], "rel_gap": s["num"] / s["den"],
                         "feature_rel_gap": s["fnum"] / s["fden"],
                         "flip_share_per_layer": [f / n for f, n in zip(s["flips"], s["entries"])]}
        row["seconds"] = time.perf_counter() - t0
        log(json.dumps(row))
        out.append(row)
        del st, model, params, ref32, ref8
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _program(model, x, impose):
    """The program's scores of x, its mask features and its decoder
    layers' `keep` masks [B, Q, keys]; with `impose`, those masks put in
    place of its own."""
    import torch

    keeps, feats = [], []
    hooks = [model.pixel_decoder.register_forward_hook(lambda m, a, out: feats.append(out[0]))]
    for i, layer in enumerate(model.predictor.layers):
        def pre(module, args, i=i):
            keeps.append(args[4][:, 0])
            if impose is not None:
                return (*args[:4], impose[i][:, None])
        hooks.append(layer.register_forward_pre_hook(pre))
    try:
        with torch.no_grad():
            got = model(x)
    finally:
        for h in hooks:
            h.remove()
    return got, feats[0], keeps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sessions", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    os.environ.setdefault("F3S_TORCH_BUILD_DIR", str(core.ROOT / "build"))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = readings([int(s) for s in args.seeds.split(",")], args.sessions)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
