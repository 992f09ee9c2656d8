"""Config-driven train / test / profile driver for the training tree
(counterpart of the JAX package's train/driver.py; reference
src/upscale/model/egvsr/main.py:18-352):

    python -m sharkshark_tpu_torch.train.driver --config cfg.yml --mode train|test|profile [--device cpu]

with a YAML option tree (configs/*.yml).  It runs on the card unless
`--device cpu` is given.  The recipes: VSR (FRNet, pixel + warping
loss), VSRGAN (TecoGAN: FRNet against a spatial or spatio-temporal
discriminator, selected by a model.discriminator block, e.g.
configs/tecogan_bd.yml), SISR (SRVGG) and denoise (BSVD-32, or BSVD-64
with `model.generator.variant: 64`).  The
generators: FRNet, srvgg, bsvd, and the variants espnet (per frame),
vespnet (a window of `depth` frames) and sofnet (3-frame windows, each
colour channel as its own Y plane).

train: data loader -> (BD degradation on the device) -> train step,
periodic test with metric JSON, checkpoints, and an exact resume
(optimizer state included, both networks' for the GAN).  The data order
and crops are seeded from manual_seed.
test: each test set through the generator's inference (FRNet's through
K3's wrapper, as the live service runs it), outputs and metrics saved;
a window generator's edge frames have no output and are not scored.
profile: conv/matmul FLOPs, parameters and calls/s of the generator on
one window of frames.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models import bsvd, egvsr, srvgg, variants
from ..models.torch_import import load_state_dict, to_tensors
from ..utils import get_logger, require_module, resolve_device
from . import checkpoint as ckpt
from .datasets import (
    PairedFolderDataset,
    PairedFolderTrainDataset,
    PairedLMDBDataset,
    UnpairedLMDBDataset,
    create_dataloader,
    gaussian_downsample_kernel,
    prepare_data,
)
from .metrics import LPIPS, MetricCalculator
from .model_summary import benchmark_fps, count_params, profile_model
from .schedules import define_lr_schedule

__all__ = ["load_config", "define_generator", "Recipe", "build_training", "make_degrade", "train_loader", "train",
           "test", "profile", "main"]

log = get_logger("train.driver")


def load_config(path: str) -> dict:
    yaml = require_module("yaml", "The driver reads its YAML configs with PyYAML.")
    with open(path) as f:
        return yaml.safe_load(f)


def _generator_name(opt: dict) -> str:
    return opt["model"]["generator"].get("name", "FRNet").lower()


def _model_cfg(opt: dict) -> egvsr.EGVSRConfig:
    g = opt.get("model", {}).get("generator", {})
    return egvsr.EGVSRConfig(
        in_nc=g.get("in_nc", 3),
        out_nc=g.get("out_nc", 3),
        nf=g.get("nf", 64),
        nb=g.get("nb", 10),
        scale=opt.get("scale", 4),
        # BD-degradation configs train with the TecoGAN bicubic flow
        # upsample (reference FRNet __init__ <- the dataset's degradation)
        degradation=opt.get("dataset", {}).get("degradation", {}).get("type", "BI"),
    )


def define_generator(opt: dict, device: str | torch.device = "cuda") -> dict:
    """Generator registry (reference models/networks/__init__.py:3-42):
    name -> {'cfg', 'window' (LR frames one output frame needs),
    'channels' (of an LR frame the network itself takes),
    'init'(torch.Generator) -> params on device, 'infer'(params, lr
    (T,H,W,C)) -> (T',sH,sW,C), and for the generators a reference .pth
    imports into, 'from_torch'(state dict) -> params on device}.
    'frnet'/'egvsr' are FRNet, 'srvgg' is per-frame SRVGG, 'bsvd' the
    denoiser; 'espnet' runs per frame, 'vespnet' and 'sofnet' slide a
    window and give T' = T - window + 1 frames (the JAX package wires no
    .pth import for these three)."""
    dev = resolve_device(device)
    name = _generator_name(opt)
    g = opt["model"]["generator"]

    if name in ("frnet", "egvsr"):
        cfg = _model_cfg(opt)
        return {
            "name": name, "cfg": cfg, "window": 1, "channels": cfg.in_nc,
            "init": lambda gen: to_tensors(egvsr.init_params(gen, cfg), dev),
            # K3 warps each HR frame, the live service's inference
            "infer": lambda p, lr: egvsr.infer_sequence(p, lr[:, None], cfg=cfg)[:, 0],
            "from_torch": lambda sd: egvsr.from_torch(sd, cfg, dev),
        }

    if name == "srvgg":
        cfg = srvgg.SRVGGConfig(num_feat=g.get("nf", 64), num_conv=g.get("num_conv", 32), upscale=opt.get("scale", 4))
        return {
            "name": name, "cfg": cfg, "window": 1, "channels": 3,
            "init": lambda gen: to_tensors(srvgg.init_params(gen, cfg), dev),
            # per frame: T rides the batch; float32, layer by layer
            "infer": lambda p, lr: srvgg.apply(p, lr, cfg=cfg, conv_stack=0),
            "from_torch": lambda sd: srvgg.from_torch(sd, cfg, dev),
        }

    if name == "bsvd":
        # same resolution, noise-map conditioned (train/denoise.py); test
        # mode feeds the dataset's lr clip as the noisy input at
        # test.noise_sigma
        from .denoise import clip_forward

        cfg = bsvd.BSVD_64 if int(g.get("variant", 32)) == 64 else bsvd.BSVD_32
        sigma = float(opt.get("test", {}).get("noise_sigma", 25.0)) / 255.0

        def infer(p, lr):
            nmap = lr.new_full(lr.shape[:-1] + (1,), sigma)
            return clip_forward(p, torch.cat([lr, nmap], dim=-1)[:, None], cfg=cfg)[:, 0]

        return {
            "name": name, "cfg": cfg, "window": 1, "channels": 3,
            "init": lambda gen: to_tensors(bsvd.init_params(gen, cfg), dev),
            "infer": infer,
            "from_torch": lambda sd: bsvd.from_torch(sd, cfg, dev),
        }

    scale = opt.get("scale", 4)
    if name == "espnet":
        cfg = variants.ESPCNConfig(scale=scale, in_nc=g.get("in_nc", 3), out_nc=g.get("out_nc", 3))
        return {
            "name": name, "cfg": cfg, "window": 1, "channels": cfg.in_nc,
            "init": lambda gen: variants.espcn_init(gen, cfg, dev),
            "infer": lambda p, lr: variants.espcn_apply(p, lr, cfg=cfg),  # frame-major = the batch
        }

    if name == "vespnet":
        cfg = variants.VESPCNConfig(scale=scale, channel=g.get("channel", 3), depth=g.get("depth", 3))
        pad = cfg.depth // 2

        def infer(p, lr):
            return torch.cat([variants.vespcn_apply(p, lr[i - pad : i + pad + 1], cfg=cfg)
                              for i in range(pad, lr.shape[0] - pad)])

        return {"name": name, "cfg": cfg, "window": cfg.depth, "channels": cfg.channel,
                "init": lambda gen: variants.vespcn_init(gen, cfg, dev), "infer": infer}

    if name == "sofnet":
        cfg = variants.SOFVSRConfig(scale=scale)

        def infer(p, lr):
            # (prev, cur, next) stacked in the channel dim, each colour
            # channel a Y plane of its own on the batch axis: (C, H, W, 3)
            outs = [variants.sofvsr_apply(p, torch.stack([lr[i - 1], lr[i], lr[i + 1]], dim=-1).permute(2, 0, 1, 3),
                                          cfg=cfg)[..., 0].permute(1, 2, 0)
                    for i in range(1, lr.shape[0] - 1)]
            return torch.stack(outs)

        return {"name": name, "cfg": cfg, "window": 3, "channels": 1,
                "init": lambda gen: variants.sofvsr_init(gen, cfg, dev), "infer": infer}

    raise ValueError(f"unrecognized generator: {name}")


def _make_dataset(opt: dict, split: str):
    dopt = opt["dataset"][split]
    degradation = opt["dataset"]["degradation"]["type"]
    seed = opt.get("manual_seed", 0)
    if split != "train":
        return PairedFolderDataset(dopt["gt_seq_dir"], dopt["lr_seq_dir"], dopt.get("filter_file"))
    sigma = opt["dataset"]["degradation"].get("sigma", 1.5)
    crop = dopt.get("crop_size", 128)
    if dopt.get("name") == "Folder":
        if degradation == "BD":
            # prepare_data cuts 2*border px off the GT on the device:
            # enlarge the crop to keep crop_size
            crop += 2 * int(sigma * 3.0)
        return PairedFolderTrainDataset(dopt["gt_seq_dir"], dopt["lr_seq_dir"], scale=opt["scale"],
                                        crop_size=crop, tempo_extent=opt["train"]["tempo_extent"], seed=seed)
    moving = dict(moving_first_frame=opt["train"].get("moving_first_frame", False),
                  moving_factor=opt["train"].get("moving_factor", 1.0), seed=seed)
    if degradation == "BI":
        return PairedLMDBDataset(dopt["gt_seq_dir"], dopt["lr_seq_dir"], scale=opt["scale"], crop_size=crop,
                                 tempo_extent=opt["train"]["tempo_extent"], **moving)
    return UnpairedLMDBDataset(dopt["gt_seq_dir"], crop_size=crop + 2 * int(sigma * 3.0),
                               tempo_extent=opt["train"]["tempo_extent"], **moving)


class Recipe(NamedTuple):
    """A config's training recipe: its train config (VSRTrainConfig,
    SISRTrainConfig, DenoiseTrainConfig or VSRGANConfig), a fresh seeded
    state (TrainState, or GANTrainState), train_step(state, lr, gt) ->
    (state, logs) and the step's loss: loss_fn(params, input, gt) ->
    (loss, logs) (for denoise the input is the noisy clip with its noise
    map, denoise.noisy_input), or for the GAN its vsrgan.GANLosses."""

    cfg: Any
    state: Any
    step: Callable
    loss_fn: Callable


def build_training(opt: dict, device: str | torch.device = "cuda") -> Recipe:
    """The config's recipe: VSRGAN for a config with a
    model.discriminator block, SISR for an srvgg generator, denoise for
    bsvd, else VSR (FRNet)."""
    dev = resolve_device(device)
    if opt.get("model", {}).get("discriminator"):
        return _build_gan(opt, dev)
    gtr = opt["train"]["generator"]
    gen = torch.Generator().manual_seed(opt.get("manual_seed", 0))
    pix = dict(pixel_crit=opt["train"].get("pixel_crit"),
               pixel_weight=opt["train"].get("pixel_crit", {}).get("weight", 1.0))
    adam = dict(beta1=gtr.get("beta1", 0.9), beta2=gtr.get("beta2", 0.999))
    name = _generator_name(opt)

    if name == "srvgg":
        from .sisr import SISRTrainConfig, create_sisr_state, make_sisr_loss_fn, make_sisr_train_step

        cfg = SISRTrainConfig(model_cfg=define_generator(opt, dev)["cfg"], lr=gtr.get("lr", 2e-4), **adam, **pix)
        sched = define_lr_schedule(gtr.get("lr_schedule"), cfg.lr)
        return Recipe(cfg, create_sisr_state(gen, cfg, device=dev), make_sisr_train_step(cfg, sched),
                      make_sisr_loss_fn(cfg))

    if name == "bsvd":
        from .denoise import DenoiseTrainConfig, create_denoise_state, make_denoise_loss_fn, make_denoise_train_step

        nopt = opt["train"].get("noise", {})
        cfg = DenoiseTrainConfig(
            model_cfg=define_generator(opt, dev)["cfg"], lr=gtr.get("lr", 1e-4), **adam, **pix,
            sigma_min=float(nopt.get("sigma_min", 10.0)) / 255.0,
            sigma_max=float(nopt.get("sigma_max", 50.0)) / 255.0,
            noise_seed=opt.get("manual_seed", 0),
        )
        sched = define_lr_schedule(gtr.get("lr_schedule"), cfg.lr)
        return Recipe(cfg, create_denoise_state(gen, cfg, device=dev), make_denoise_train_step(cfg, sched),
                      make_denoise_loss_fn(cfg))

    from .vsr import VSRTrainConfig, create_train_state, make_loss_fn, make_train_step

    if name not in ("frnet", "egvsr"):
        define_generator(opt, dev)  # raises for an unknown name
        # the JAX driver trains FRNet under a variant's name; refuse instead
        raise ValueError(f"no training recipe for generator {name!r} (FRNet, srvgg and bsvd have one); "
                         "test and profile take it")
    cfg = VSRTrainConfig(
        model_cfg=_model_cfg(opt), lr=gtr.get("lr", 5e-5), **adam, **pix,
        warping_crit=opt["train"].get("warping_crit"),
        warping_weight=opt["train"].get("warping_crit", {}).get("weight", 1.0),
    )
    sched = define_lr_schedule(gtr.get("lr_schedule"), cfg.lr)
    return Recipe(cfg, create_train_state(gen, cfg, device=dev), make_train_step(cfg, sched), make_loss_fn(cfg))


def _build_gan(opt: dict, dev: torch.device) -> Recipe:
    """The VSRGAN recipe (reference VSRGANModel; the JAX driver's
    :279-333): FRNet against the spatial D ('SNet') or the
    spatio-temporal D, sized to the GT crop; ping-pong and feature
    matching on when their criteria are configured; the VGG feature loss
    when train.feature_crit.vgg_weights names a file."""
    from .vsrgan import VSRGANConfig, create_gan_state, make_gan_loss_fns, make_gan_train_step
    from .discriminators import DiscriminatorConfig

    tr = opt["train"]
    dopt, gtr, dtr = opt["model"]["discriminator"], tr["generator"], tr.get("discriminator", {})
    crop = opt["dataset"]["train"].get("crop_size", 128)
    if opt["dataset"]["degradation"]["type"] == "BI":
        crop = opt["dataset"]["train"].get("gt_crop_size", crop)
    cfg = VSRGANConfig(
        model_cfg=_model_cfg(opt),
        disc_cfg=DiscriminatorConfig(in_nc=dopt.get("in_nc", 3), spatial_size=crop,
                                     tempo_range=dopt.get("tempo_range", 3), scale=opt.get("scale", 4),
                                     use_cond=dopt.get("use_cond", False)),
        disc_type="spatial" if dopt.get("name", "stnet").lower() == "snet" else "spatio_temporal",
        lr_g=gtr.get("lr", 5e-5),
        lr_d=dtr.get("lr", 5e-5),
        pixel_weight=tr.get("pixel_crit", {}).get("weight", 1.0),
        warping_weight=tr.get("warping_crit", {}).get("weight", 1.0),
        pingpong_weight=tr.get("pingpong_crit", {}).get("weight", 0.5),
        fm_weight=tr.get("feature_matching_crit", {}).get("weight", 1.0),
        gan_weight=tr.get("gan_crit", {}).get("weight", 0.01),
        use_pingpong="pingpong_crit" in tr,
        use_feature_matching="feature_matching_crit" in tr,
        crop_border_ratio=dtr.get("crop_border_ratio", 0.75),
        update_policy=dtr.get("update_policy", "adaptive"),
        update_threshold=dtr.get("update_threshold", 0.4),
        gan_crit=tr.get("gan_crit", {}).get("type", "GAN"),
        feature_weight=tr.get("feature_crit", {}).get("weight", 0.2),
    )
    if gtr.get("lr_schedule") or dtr.get("lr_schedule"):
        log.warning("the GAN step updates at the fixed rates lr_g=%g and lr_d=%g and ignores lr_schedule, "
                    "as the JAX package's step does", cfg.lr_g, cfg.lr_d)
    fx = None
    vgg_path = tr.get("feature_crit", {}).get("vgg_weights")
    if vgg_path:
        from .vgg import VGGFeatureExtractor

        fx = VGGFeatureExtractor(vgg_path, device=dev)
    state = create_gan_state(torch.Generator().manual_seed(opt.get("manual_seed", 0)), cfg, device=dev)
    return Recipe(cfg, state, make_gan_train_step(cfg, fx), make_gan_loss_fns(cfg, fx))


def make_degrade(opt: dict, device: str | torch.device = "cuda"):
    """The BD degradation of the config's training batches on `device`
    (gt with its border -> {'gt', 'lr'}), or None for BI data."""
    dopt = opt["dataset"]["degradation"]
    if dopt["type"] != "BD":
        return None
    kernel = torch.from_numpy(gaussian_downsample_kernel(dopt.get("sigma", 1.5))).to(resolve_device(device))

    def degrade(gt):
        return prepare_data(gt, kernel, opt["scale"], dopt.get("sigma", 1.5))

    return degrade


def train_loader(opt: dict):
    """The config's training batches (numpy), shuffled and cropped from
    manual_seed."""
    loader = create_dataloader(
        _make_dataset(opt, "train"),
        batch_size=opt["dataset"]["train"].get("batch_size", 4),
        num_workers=opt["dataset"]["train"].get("num_workers", 0),
        generator=torch.Generator().manual_seed(opt.get("manual_seed", 0)),
    )
    if len(loader) == 0:
        raise ValueError("the training set is empty")
    return loader


def train(opt: dict, device: str | torch.device = "cuda") -> dict:
    """Train to train.total_iter, resuming from the newest checkpoint in
    train.ckpt_dir unless train.resume is false.  Returns {'iter',
    'resumed_from', 'losses' (l_total of each iteration this run; the
    GAN's l_total_G), 'logs' (each log's values, one an iteration),
    'checkpoints', 'tests' (label -> results of the periodic tests)}, and
    for the GAN 'cnt_upd_d' (D updates since the run's first step)."""
    dev = resolve_device(device)
    np.random.seed(opt.get("manual_seed", 0))
    recipe = build_training(opt, dev)
    state, step_fn = recipe.state, recipe.step

    ckpt_dir = opt["train"].get("ckpt_dir", "./ckpt")
    resume = ckpt.latest_checkpoint(ckpt_dir) if opt["train"].get("resume", True) else None
    if resume:
        ckpt.load_checkpoint(resume, state)
        log.info("resumed from %s (iter %d)", resume, state.step)

    degrade = make_degrade(opt, dev)
    loader = train_loader(opt)
    total_iter = opt["train"].get("total_iter", 100000)
    log_freq = opt.get("logger", {}).get("log_freq", 100)
    save_freq = opt["train"].get("ckpt_freq", 5000)
    test_freq = opt.get("test", {}).get("test_freq", 0)

    res = {"resumed_from": resume, "losses": [], "logs": {}, "checkpoints": [], "tests": {}}
    history: dict[str, list] = {}
    it = state.step
    t0 = time.time()
    while it < total_iter:
        for batch in loader:
            if it >= total_iter:
                break
            gt = torch.from_numpy(batch["gt"]).to(dev)
            data = degrade(gt) if degrade else {"gt": gt, "lr": torch.from_numpy(batch["lr"]).to(dev)}
            state, logs = step_fn(state, data["lr"], data["gt"])
            for k, v in logs.items():
                history.setdefault(k, []).append(v)
            it += 1
            if it % log_freq == 0:
                msg = " ".join(f"{k}={float(v):.4f}" for k, v in logs.items())
                log.info("iter %d (%.1f it/s): %s", it, log_freq / (time.time() - t0 + 1e-9), msg)
                t0 = time.time()
            if save_freq and it % save_freq == 0:
                res["checkpoints"].append(ckpt.save_checkpoint(ckpt_dir, state, it))
                log.info("saved %s", res["checkpoints"][-1])
            if test_freq and it % test_freq == 0:
                res["tests"][f"iter_{it}"] = test(opt, params=state.params, label=f"iter_{it}", device=dev)
    if not (save_freq and it % save_freq == 0):
        res["checkpoints"].append(ckpt.save_checkpoint(ckpt_dir, state, it))
    res["iter"] = it
    res["logs"] = {k: torch.stack(v).tolist() for k, v in history.items()}
    res["losses"] = res["logs"].get("l_total_G", res["logs"].get("l_total", []))
    if hasattr(state, "cnt_upd_d"):
        res["cnt_upd_d"] = state.cnt_upd_d
    log.info("training done at iter %d", it)
    return res


def _load_generator_params(gen: dict, load_path: str, dev: torch.device) -> dict:
    """A checkpoint of this package (a ckpt_* file, or a directory of
    them: the newest) or a reference-layout .pth state dict."""
    if os.path.isdir(load_path):
        path = ckpt.latest_checkpoint(load_path)
        if path is None:
            raise FileNotFoundError(f"no ckpt_* checkpoint in {load_path}")
        return to_tensors(ckpt.load_params(path), dev)
    if os.path.basename(load_path).startswith("ckpt_"):
        return to_tensors(ckpt.load_params(load_path), dev)
    if "from_torch" not in gen:
        raise ValueError(f".pth import is not wired for {gen['name']}: give a checkpoint of this package")
    return gen["from_torch"](load_state_dict(load_path))


def test(opt: dict, params=None, label: str = "final", device: str | torch.device = "cuda") -> dict:
    """Run each `test*` dataset split through the generator; returns
    {split: average metrics}."""
    dev = resolve_device(device)
    gen = define_generator(opt, dev)
    if params is None:
        load_path = opt["model"]["generator"].get("load_path")
        if not load_path:
            raise ValueError("test mode needs model.generator.load_path or params")
        params = _load_generator_params(gen, load_path, dev)

    topt = opt.get("test", {})
    # temporal padding for warm-up (reference base_model.py:91-117)
    padding_mode = topt.get("padding_mode", "reflect")
    n_pad_front = topt.get("num_pad_front", 0)
    metric_names = topt.get("metrics", ["PSNR"])
    lpips = None
    if "LPIPS" in metric_names:
        # explicit [alexnet_sd, linear_sd] paths (ingested reference
        # weights) win; the default is the committed minted pair
        lp = topt.get("lpips_weights")
        lpips = LPIPS(*lp, device=dev) if lp else LPIPS.minted(dev)
    results = {}
    for split in [k for k in opt["dataset"] if k.startswith("test")]:
        calc = MetricCalculator(metrics=metric_names, psnr_colorspace=topt.get("psnr_colorspace", "y"), lpips=lpips)
        for sample in _make_dataset(opt, split):
            lr = torch.from_numpy(sample["lr"]).to(dev)  # (T, h, w, C)
            t_real = lr.shape[0]
            lr, n_pad = egvsr.pad_sequence(lr, n_pad_front, padding_mode)
            with torch.no_grad():
                hr = gen["infer"](params, lr).cpu().numpy()
            if n_pad and len(hr) == lr.shape[0]:
                hr = hr[n_pad : n_pad + t_real]  # drop the warm-up outputs
            hr_u8 = np.clip(hr * 255 + 0.5, 0, 255).astype(np.uint8)
            gt = sample["gt"]
            if len(hr_u8) < len(gt):
                # a window generator (vespnet, sofnet) drops edge frames
                off = (len(gt) - len(hr_u8)) // 2
                gt = gt[off : off + len(hr_u8)]
            calc.compute_sequence_metrics(sample["seq_idx"], gt, hr_u8)
            if topt.get("res_dir"):
                _save_seq(topt["res_dir"], split, sample["seq_idx"], hr_u8)
        results[split] = calc.average()
        log.info("%s %s: %s", label, split, results[split])
        if topt.get("json_dir"):
            os.makedirs(topt["json_dir"], exist_ok=True)
            calc.save(os.path.join(topt["json_dir"], f"{split}_avg.json"), label)
    return results


def _save_seq(root: str, split: str, seq: str, frames: np.ndarray) -> None:
    import cv2

    d = os.path.join(root, split, seq)
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(d, f"{i:04d}.png"), f[..., ::-1])


def profile(opt: dict, device: str | torch.device = "cuda") -> dict:
    """FLOPs (convs and matmuls), parameters and calls/s of the config's
    generator on one window of frames (one output frame) of
    test.profile_size (h, w), seeded weights."""
    dev = resolve_device(device)
    gen = define_generator(opt, dev)
    h, w = opt.get("test", {}).get("profile_size", (256, 448))
    params = gen["init"](torch.Generator().manual_seed(0))
    lr = torch.zeros((gen["window"], h, w, gen["channels"]), device=dev)
    stats = profile_model(gen["infer"], params, lr)
    stats["params"] = count_params(params)
    stats["fps"] = benchmark_fps(gen["infer"], params, lr)
    stats["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log.info("profile %s @%dx%d on %s: %.2f GFLOPs, %.2fM params, %.1f fps",
             gen["name"], h, w, stats["device"], stats["flops"] / 1e9, stats["params"] / 1e6, stats["fps"])
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(prog="sharkshark_tpu_torch.train.driver")
    p.add_argument("--config", required=True)
    p.add_argument("--mode", choices=["train", "test", "profile"], default="train")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    opt = load_config(args.config)
    return {"train": train, "test": test, "profile": profile}[args.mode](opt, device=dev)


if __name__ == "__main__":
    main()
