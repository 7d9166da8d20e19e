"""Command-line interface of the PyTorch port: every pipeline stage as a
subcommand, with the JAX package's names, arguments and defaults.

  python -m fusion3dseg_tpu_torch seg2d <rgb_dir> <mask_dir> [--conf-threshold ...]
  python -m fusion3dseg_tpu_torch ingest <export_dir> [--write-cache]
  python -m fusion3dseg_tpu_torch fuse <session_dir> <out_dir> [--radius ...]
  python -m fusion3dseg_tpu_torch seg3d <out_dir> <mask_dir> [--threshold ...]
  python -m fusion3dseg_tpu_torch remove-classes <out_dir> <mask_dir>
  python -m fusion3dseg_tpu_torch doorwindow <out_dir>
  python -m fusion3dseg_tpu_torch refine <out_dir> <seed_point> [--mode depth|color]
  python -m fusion3dseg_tpu_torch tum <seq_dir> [out_dir] [--intrinsics fr1]
  python -m fusion3dseg_tpu_torch synth <out_dir> [--frames ...]
  python -m fusion3dseg_tpu_torch train [--steps ...]
  python -m fusion3dseg_tpu_torch import-hf <checkpoint> <out_npz>
  python -m fusion3dseg_tpu_torch calibrate [--model ...]
  python -m fusion3dseg_tpu_torch all <export_dir> <out_dir>   (seg2d -> fuse -> seg3d)

Subcommands that run tensors take `--device` (default cuda; `--device cpu`
runs on the CPU). `train` trains on one device.
"""

from __future__ import annotations

import argparse

MODELS = ["b0", "b1", "b2", "b3", "b4", "b5"]


def parse_hw_list(spec: str):
    """'96x72,128x96' -> ((96, 72), (128, 96)), the --render-hws format; an
    argparse `type`, so a malformed spec is a usage error."""
    out = []
    for hw in spec.split(","):
        try:
            h, w = hw.lower().split("x")
            out.append((int(h), int(w)))
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"bad resolution {hw!r} in {spec!r}: expected "
                "'HxW' or 'HxW,HxW,...' (e.g. '96x72,128x96')")
        if out[-1][0] <= 0 or out[-1][1] <= 0:
            raise argparse.ArgumentTypeError(f"non-positive resolution {hw!r} in {spec!r}")
    return tuple(out)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fusion3dseg_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, help, device=True):
        s = sub.add_parser(name, help=help)
        if device:
            s.add_argument("--device", default="cuda",
                           help="torch device to run on (default cuda; cpu runs on the CPU)")
        return s

    s = add("seg2d", "2D semantic segmentation of RGB frames")
    s.add_argument("input_dir")
    s.add_argument("output_dir")
    s.add_argument("--model", choices=MODELS, default="b2")
    s.add_argument("--extension", default="jpg")
    s.add_argument("--conf-threshold", type=float, default=0.017)
    s.add_argument("--checkpoint", default=None,
                   help="checkpoint dir or .npz snapshot; defaults to the in-repo shipped "
                        "snapshot for the chosen model when one exists (pass 'random' to skip)")
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--input-size", type=int, default=None,
                   help="model input resolution; default: the size the checkpoint was "
                        "trained at (its recorded metadata)")

    s = add("ingest", "load an rtabmap-export dir; optionally write the pickle cache")
    s.add_argument("export_dir")
    s.add_argument("--write-cache", action="store_true")
    s.add_argument("--padding", action="store_true")

    s = add("fuse", "multi-view fusion -> sparse cloud + uv2pt")
    s.add_argument("input_dir")
    s.add_argument("output_dir")
    s.add_argument("--radius", type=float, default=0.05)
    s.add_argument("--angle", type=float, default=10.0)
    s.add_argument("--stride", type=int, default=10)
    s.add_argument("--min-depth", type=float, default=0.1)
    s.add_argument("--max-depth", type=float, default=4.0)
    s.add_argument("--decimation", type=int, default=1)
    s.add_argument("--min-occ", type=int, default=3)
    s.add_argument("--apply-min-occ", action="store_true",
                   help="actually drop low-occurrence points and remap uv2pt "
                        "(the reference computes but discards this filter)")
    s.add_argument("--capacity", type=int, default=1 << 20,
                   help="sparse buffer capacity; 0 = auto-size")

    s = add("seg3d", "vote + classify + instance split + master classes")
    s.add_argument("session_dir")
    s.add_argument("mask_dir")
    s.add_argument("--threshold", type=float, default=0.5)
    s.add_argument("--nclasses", type=int, default=133)
    s.add_argument("--filter-classes", type=int, nargs="*", default=[86, 114, 115],
                   help="restrict the argmax to these classes (the reference's default); "
                        "use --all-classes to classify over every class")
    s.add_argument("--all-classes", action="store_true")
    s.add_argument("--min-pts-per-inst", type=int, default=100)

    s = add("remove-classes", "keep-class filtering / scene cleanup")
    s.add_argument("session_dir")
    s.add_argument("mask_dir")
    s.add_argument("--threshold", type=float, default=0.75)
    s.add_argument("--keep-classes", type=int, nargs="*", default=None)

    s = add("doorwindow", "door/window rectangle meshes", device=False)
    s.add_argument("session_dir")
    s.add_argument("--proxy-mesh", default=None)

    s = add("refine", "grow an instance by depth/color flood fill")
    s.add_argument("session_dir")
    s.add_argument("seed_point", type=int,
                   help="point index (batch replacement for interactive picking)")
    s.add_argument("--mode", choices=["depth", "color"], default="depth")
    s.add_argument("--threshold", type=float, default=None)
    s.add_argument("--max-level", type=int, default=50)
    s.add_argument("--wall-point", type=float, nargs=3, default=None)
    s.add_argument("--wall-normal", type=float, nargs=3, default=None)
    s.add_argument("--radius", type=float, default=0.1, help="adjacency radius")
    s.add_argument("--from-point", action="store_true",
                   help="grow from the single seed instead of its whole instance")

    s = add("tum", "ingest a TUM RGB-D sequence (convert to an rtabmap-export-style dir, "
                   "or just probe it)")
    s.add_argument("seq_dir", help="TUM sequence dir (rgb.txt/depth.txt/groundtruth.txt)")
    s.add_argument("out_dir", nargs="?", default=None,
                   help="write an export-style dir here; omit to only probe/associate and "
                        "print session stats")
    s.add_argument("--intrinsics", default="ros_default",
                   help="freiburg preset (fr1/fr2/fr3/ros_default; auto-matched against the "
                        "dir name) or fx,fy,cx,cy")
    s.add_argument("--max-difference", type=float, default=0.02,
                   help="association timestamp tolerance (seconds)")

    s = add("synth", "generate a synthetic test session", device=False)
    s.add_argument("out_dir")
    s.add_argument("--frames", type=int, default=32)
    s.add_argument("--height", type=int, default=256)
    s.add_argument("--width", type=int, default=192)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--appearance", choices=["flat", "textured"], default="flat",
                   help="flat class colours, or per-session palettes + textures + lighting "
                        "(what the shipped segmenters were trained on)")

    s = add("train", "train the 2D segmenter")
    s.add_argument("--steps", type=int, default=1000)
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--lr", type=float, default=6e-5)
    s.add_argument("--checkpoint-dir", default=None)
    s.add_argument("--rgb-dir", default=None)
    s.add_argument("--mask-dir", default=None)
    s.add_argument("--input-size", type=int, default=256)
    s.add_argument("--model", choices=MODELS, default="b0")
    s.add_argument("--appearance", choices=["flat", "textured"], default="flat",
                   help="synthetic-dataset appearance (textured = per-session palettes + "
                        "textures + lighting)")
    s.add_argument("--eval-miou", action="store_true",
                   help="after training, report held-out mIoU/pixel-acc on fresh textured "
                        "sessions")
    s.add_argument("--schedule", choices=["cosine", "constant"], default="cosine")
    s.add_argument("--warmup-steps", type=int, default=200)
    s.add_argument("--weight-decay", type=float, default=0.01)
    s.add_argument("--augment", action="store_true",
                   help="host-side flip + photometric augmentation")
    s.add_argument("--aug-strength", type=float, default=1.0,
                   help="scales every augmentation jitter range; >1 adds cutout occluders")
    s.add_argument("--boundary-weight", type=float, default=1.0,
                   help="loss up-weight for pixels touching a ground-truth label edge "
                        "(1.0 = plain cross entropy)")
    s.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an exponential moving average of the parameters (e.g. 0.999), "
                        "committed as <checkpoint-dir>/ema (a Segmenter2D checkpoint dir)")
    s.add_argument("--prefetch", type=int, default=2,
                   help="producer-thread batch prefetch depth (0 = synchronous generation)")
    s.add_argument("--render-hws", default="96x72", type=parse_hw_list,
                   help="comma-separated raycast resolutions sampled per synthetic session, "
                        "e.g. '96x72,128x96,192x144' (frames are resized to --input-size)")
    s.add_argument("--device-datagen", action="store_true",
                   help="generate batches on the device (raycast, shade and augment in "
                        "torch; textured regime)")
    s.add_argument("--resume", action="store_true",
                   help="resume params/opt-state/step from --checkpoint-dir")
    s.add_argument("--init-npz", default=None,
                   help="warm-start params from an npz snapshot (e.g. an import-hf "
                        "conversion); ignored when resuming")
    s.add_argument("--upright", action="store_true",
                   help="corrected (upright) camera convention for the synthetic dataset + "
                        "eval (the legacy default matches the shipped weights)")

    s = add("import-hf", "convert a HuggingFace SegFormer checkpoint (mit-bX / "
                         "segformer-bX-finetuned-*) to a snapshot Segmenter2D loads: the "
                         "encoder (+ compatible decoder projections) by default, the full "
                         "model with --with-head", device=False)
    s.add_argument("checkpoint", help=".pth/.bin/.safetensors state dict")
    s.add_argument("out_npz")
    s.add_argument("--num-classes", type=int, default=134)
    s.add_argument("--seed", type=int, default=0,
                   help="init seed for the non-imported decoder head")
    s.add_argument("--input-size", type=int, default=512,
                   help="resolution the HF checkpoint was trained at (recorded in the "
                        "snapshot so loaders default to it; HF segformer-finetuned models "
                        "use 512)")
    s.add_argument("--with-head", action="store_true",
                   help="also transplant the decode head (bias-free fuse + BatchNorm + "
                        "classifier): the snapshot predicts the checkpoint's own taxonomy "
                        "with no fine-tune (needs a SegformerForSemanticSegmentation "
                        "checkpoint, not an encoder-only mit-bX)")

    s = add("calibrate", "sweep seg2d conf_threshold through the model-in-the-loop 3D "
                         "protocol and report the calibrated operating point")
    s.add_argument("--model", choices=MODELS, default=None,
                   help="default: the best shipped snapshot")
    s.add_argument("--checkpoint", default=None)
    s.add_argument("--sessions", type=int, default=3)
    s.add_argument("--frames", type=int, default=24)
    s.add_argument("--max-unclassified", type=float, default=0.01)
    s.add_argument("--batch-size", type=int, default=8)

    s = add("all", "full pipeline: ingest -> seg2d -> fuse -> seg3d")
    s.add_argument("export_dir")
    s.add_argument("output_dir")
    s.add_argument("--mask-dir", default=None, help="use existing masks instead of running seg2d")
    s.add_argument("--radius", type=float, default=0.05)
    s.add_argument("--model", choices=MODELS, default="b2")
    s.add_argument("--checkpoint", default=None,
                   help="seg2d weights; defaults to the shipped snapshot for --model when "
                        "one exists")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    globals()["_" + args.cmd.replace("-", "_")](args)


def _seg2d(args):
    from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
    from fusion3dseg_tpu_torch.pipeline.get2dseg import SegmentImage, Segmenter2D

    ckpt = args.checkpoint
    if ckpt is None:
        ckpt = convert.shipped_checkpoint(args.model)
        if ckpt is not None:
            print(f"using shipped weights {ckpt}")
    elif ckpt == "random":
        ckpt = None
    seg = Segmenter2D(config=SegFormerConfig.named(args.model), checkpoint_dir=ckpt,
                      batch_size=args.batch_size,
                      input_hw=(args.input_size, args.input_size) if args.input_size else None,
                      device=args.device)
    print(f"input size: {seg.input_hw[0]}x{seg.input_hw[1]}")
    SegmentImage(args.input_dir, args.output_dir, extension=args.extension,
                 conf_threshold=args.conf_threshold, segmenter=seg,
                 batch_size=args.batch_size, verbose=True)


def _ingest(args):
    from fusion3dseg_tpu_torch.io import rtab

    sd = rtab.SessionData.from_export_dir(args.export_dir, padding=args.padding,
                                          device=args.device)
    print(f"{sd.nframes} frames, depth {sd.depth_hw}, rgb {sd.rgb_hw}")
    if args.write_cache:
        sub_name = sd.write_cache(args.export_dir)
        print(f"wrote PointcloudMergeResults cache ({sub_name})")


def _fuse(args):
    from fusion3dseg_tpu_torch.pipeline.process3d import process3DSeg

    out = process3DSeg(args.input_dir, args.output_dir, radius=args.radius, angle=args.angle,
                       stride=args.stride, point_range=(args.min_depth, args.max_depth),
                       decimation=args.decimation, min_occ=args.min_occ,
                       capacity=args.capacity or None, verbose=True,
                       apply_min_occ=args.apply_min_occ, device=args.device)
    print(f"fused cloud: {len(out[0])} points")


def _seg3d(args):
    from fusion3dseg_tpu_torch.pipeline.get3dseg import segment

    segment(args.session_dir, args.mask_dir, threshold=args.threshold, nclasses=args.nclasses,
            filter_classes=None if args.all_classes else args.filter_classes,
            min_pts_per_inst=args.min_pts_per_inst, verbose=True, device=args.device)


def _remove_classes(args):
    from fusion3dseg_tpu_torch.pipeline.get3dseg import remove_classes

    mask = remove_classes(args.session_dir, args.mask_dir, keep_classes=args.keep_classes,
                          threshold=args.threshold, verbose=True, device=args.device)
    print(f"remaining points: {int(mask.sum())}/{len(mask)}")


def _doorwindow(args):
    from fusion3dseg_tpu_torch.pipeline.door_window import generate_mesh

    tri_ids, _, _ = generate_mesh(args.session_dir, proxy_mesh=args.proxy_mesh)
    print(f"{len(tri_ids) // 2} door/window quads")


def _refine(args):
    import numpy as np

    from fusion3dseg_tpu_torch.io import artifacts, native
    from fusion3dseg_tpu_torch.pipeline import refinement

    pts, _, colors, *_ = artifacts.load_fusion_data(args.session_dir)
    adj = native.radius_graph(np.asarray(pts, np.float32), args.radius, k=16)
    if args.mode == "depth":
        if args.wall_point is None or args.wall_normal is None:
            raise SystemExit("depth mode needs --wall-point and --wall-normal")
        ids, grown = refinement.depth_floodfill(
            args.session_dir, adj, args.seed_point, np.asarray(args.wall_point),
            np.asarray(args.wall_normal),
            depth_threshold=args.threshold if args.threshold is not None else 0.03,
            max_level=args.max_level, grow_from_instance=not args.from_point,
            device=args.device)
    else:
        ids, grown = refinement.color_floodfill(
            args.session_dir, adj, args.seed_point,
            np.asarray(colors) if colors is not None else np.zeros_like(pts),
            color_threshold=args.threshold if args.threshold is not None else 0.1,
            max_level=args.max_level, grow_from_instance=not args.from_point,
            device=args.device)
    print(f"grew {int(grown.sum())} points; wrote cv_segmentation/")


def _tum(args):
    from fusion3dseg_tpu_torch.io import tum

    intr = args.intrinsics
    if "," in intr:
        intr = tuple(float(x) for x in intr.split(","))
    if args.out_dir is not None:
        out = tum.convert_to_export_dir(args.seq_dir, args.out_dir, intrinsics=intr,
                                        max_difference=args.max_difference)
        print(f"wrote export-style session to {out}")
    else:
        sd, _ = tum.load_session(args.seq_dir, intrinsics=intr,
                                 max_difference=args.max_difference, device=args.device)
        print(f"{sd.nframes} associated frames, depth {sd.depth_hw}, rgb {sd.rgb_hw}")


def _synth(args):
    from fusion3dseg_tpu_torch.io import synthetic

    sess = synthetic.make_session(nframes=args.frames, depth_hw=(args.height, args.width),
                                  room=synthetic.RoomSpec(seed=args.seed),
                                  appearance=args.appearance)
    synthetic.write_session_dir(sess, args.out_dir)
    print(f"wrote {args.frames}-frame synthetic session to {args.out_dir}")


def _train(args):
    from pathlib import Path

    from fusion3dseg_tpu_torch.models import SegFormerConfig
    from fusion3dseg_tpu_torch.models.train import (
        TrainConfig, directory_dataset, evaluate_synthetic, train,
    )
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    cfg = TrainConfig(
        model=SegFormerConfig.named(args.model), steps=args.steps,
        batch_size=args.batch_size, learning_rate=args.lr,
        checkpoint_dir=args.checkpoint_dir, input_hw=(args.input_size, args.input_size),
        appearance=args.appearance, upright=args.upright, lr_schedule=args.schedule,
        warmup_steps=args.warmup_steps, weight_decay=args.weight_decay,
        augment=args.augment, aug_strength=args.aug_strength,
        boundary_weight=args.boundary_weight, ema_decay=args.ema_decay,
        prefetch=args.prefetch, render_hws=args.render_hws,
        device_datagen=args.device_datagen, resume=args.resume,
        init_params_npz=args.init_npz,
    )
    ds = None
    if args.rgb_dir and args.mask_dir:
        ds = directory_dataset(args.rgb_dir, args.mask_dir, cfg.input_hw, cfg.batch_size)
    _, loss = train(cfg, dataset=ds, device=args.device)
    print(f"final loss: {float(loss)}")
    if args.eval_miou and args.checkpoint_dir:
        runs = [("", Path(args.checkpoint_dir))]
        if (Path(args.checkpoint_dir) / "ema" / "params").exists():
            runs.append((" (EMA)", Path(args.checkpoint_dir) / "ema"))
        for tag, ckpt in runs:
            seg = Segmenter2D(config=SegFormerConfig.named(args.model), checkpoint_dir=ckpt,
                              input_hw=cfg.input_hw, batch_size=args.batch_size,
                              device=args.device)
            stats = evaluate_synthetic(seg, appearance=args.appearance, upright=args.upright)
            print(f"held-out miou{tag}: {stats['miou']:.4f} "
                  f"pixel_acc: {stats['pixel_acc']:.4f}")


def _import_hf(args):
    import torch

    from fusion3dseg_tpu_torch.models.import_hf import (
        infer_config_from_state_dict, load_hf_state_dict, params_from_hf_segformer,
        save_snapshot,
    )
    from fusion3dseg_tpu_torch.models.segformer import SegFormer

    sd = load_hf_state_dict(args.checkpoint)
    cfg = infer_config_from_state_dict(sd, num_classes=args.num_classes,
                                       with_head=args.with_head)
    print(f"inferred encoder geometry: dims {cfg.embed_dims} depths {cfg.depths} "
          f"sr {cfg.sr_ratios} decoder {cfg.decoder_dim}"
          + (f"; full head transplant, {cfg.num_classes} classes" if args.with_head else ""))
    # the non-imported parameters start from a seeded float32 init
    template = SegFormer(cfg, torch.Generator().manual_seed(args.seed),
                         param_dtype=torch.float32).state_dict()
    params = params_from_hf_segformer(sd, cfg, params_template=template,
                                      include_head=args.with_head)
    save_snapshot(args.out_npz, params, cfg, input_hw=(args.input_size, args.input_size))
    if args.with_head:
        print(f"wrote {args.out_npz} — drop-in runnable: Segmenter2D(checkpoint_dir=...) "
              "rebuilds the recorded architecture (predicts the checkpoint's taxonomy)")
    else:
        print(f"wrote {args.out_npz} — fine-tune the decoder with: "
              "python -m fusion3dseg_tpu_torch train --init-npz ...")


def _calibrate(args):
    import json

    from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
    from fusion3dseg_tpu_torch.models.calibrate import pick_threshold, sweep_conf_threshold
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    if args.model is None:
        model, ckpt = convert.best_shipped_checkpoint()
        if model is None:
            raise SystemExit("no shipped checkpoint; pass --model/--checkpoint")
    else:
        model = args.model
        ckpt = args.checkpoint or convert.shipped_checkpoint(model)
    seg = Segmenter2D(config=SegFormerConfig.named(model), checkpoint_dir=ckpt,
                      batch_size=args.batch_size, device=args.device)
    seeds = tuple(777 + 7001 * i for i in range(args.sessions))
    rows = sweep_conf_threshold(seg, session_seeds=seeds, nframes=args.frames, verbose=True)
    for r in rows:
        print(json.dumps(r))
    print("calibrated:", json.dumps(pick_threshold(rows, max_unclassified=args.max_unclassified)))


def _all(args):
    from pathlib import Path

    from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
    from fusion3dseg_tpu_torch.pipeline.get2dseg import SegmentImage, Segmenter2D
    from fusion3dseg_tpu_torch.pipeline.get3dseg import segment
    from fusion3dseg_tpu_torch.pipeline.process3d import process3DSeg

    mask_dir = args.mask_dir
    if mask_dir is None:
        mask_dir = str(Path(args.output_dir) / "masks")
        ckpt = args.checkpoint or convert.shipped_checkpoint(args.model)
        if ckpt == "random":  # the seg2d subcommand's sentinel
            ckpt = None
        seg2d = None
        if ckpt is not None:
            print(f"seg2d weights: {ckpt}")
            seg2d = Segmenter2D(config=SegFormerConfig.named(args.model), checkpoint_dir=ckpt,
                                device=args.device)
        SegmentImage(str(Path(args.export_dir) / "rgb"), mask_dir, segmenter=seg2d,
                     verbose=True, device=args.device)
    process3DSeg(args.export_dir, args.output_dir, radius=args.radius, verbose=True,
                 device=args.device)
    segment(args.output_dir, mask_dir, verbose=True, device=args.device)
    print("pipeline complete")


if __name__ == "__main__":
    main()
