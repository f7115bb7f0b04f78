"""The PTQ driver (port of ``tools/quant/quant_driver.py``): build the model
(seed 4, as the reference pins it), load a checkpoint, evaluate it in fp32,
quantize it with a recipe, calibrate it when static, and evaluate it again,
reporting both side by side.

    python -m q3d_tpu_torch.tools.quant_driver --cfg_file CFG [--ckpt CKPT]
        [--deploy_int8 [--no_sq] [--static --amax_method entropy]]
        [--device cpu]

Without ``--deploy_int8`` it runs the recipe's fake-quant rules
(``centerpoint_recipe``, ``second_recipe``, ``pointpillar_recipe``,
``voxelnext_recipe`` or ``transfusion_recipe``; SmoothQuant unless
``--no_sq``); with it,
``int8_deploy_recipe(sq=not no_sq, alpha, static)``, true-int8 GEMMs.
``--ckpt`` takes the reference's native checkpoint or a pcdet ``.pth``.
``--set KEY VALUE ...`` overrides the config, as ``tools/test.py``'s does.
"""

import argparse

RECIPES = ("centerpoint", "second", "pointpillar", "voxelnext", "transfusion")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--w_bits", type=int, default=8)
    parser.add_argument("--act_bits", type=int, default=8)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--no_sq", action="store_true")
    parser.add_argument("--static", action="store_true")
    parser.add_argument("--calib_batches", type=int, default=200)
    parser.add_argument("--amax_method", default="entropy",
                        choices=["entropy", "percentile", "mse", "max"])
    parser.add_argument("--deploy_int8", action="store_true",
                        help="run true-int8 GEMMs instead of fake-quant")
    parser.add_argument("--skip_fp_baseline", action="store_true")
    parser.add_argument("--infer_time", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain versions)")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def run(recipe_name="centerpoint", argv=None, frames=None):
    """Run the driver on ``argv`` (None = the command line) -> (fp32
    metrics, quantized metrics).  ``frames`` (a dict) receives each eval's
    per-frame host arrays under "fp" and "quant"."""
    if recipe_name not in RECIPES:
        raise ValueError(f"unknown recipe {recipe_name!r}")
    args = parse_args(argv)

    from ..config import EDict, cfg_from_list, cfg_from_yaml_file
    from ..datasets import build_dataloader
    from ..eval_utils import eval_one_epoch
    from ..models import build_network, load_data_to_device
    from ..quant import api as quant_api
    from ..utils import common_utils
    from ..utils.checkpoint import load_params_from_file

    common_utils.set_random_seed(4)          # the reference pins seed 4
    cfg = cfg_from_yaml_file(args.cfg_file, EDict())
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    logger = common_utils.create_logger()
    logger.info(f"PTQ driver [{recipe_name}] w={args.w_bits} "
                f"act={args.act_bits} sq={not args.no_sq} alpha={args.alpha} "
                f"static={args.static} deploy_int8={args.deploy_int8} "
                f"device={args.device}")

    test_set, test_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, args.batch_size, training=False)
    names = list(cfg.CLASS_NAMES)
    model = build_network(cfg.MODEL, len(names), test_set, device=args.device)
    if args.ckpt:
        load_params_from_file(model, args.ckpt, logger=logger)
    frames = {} if frames is None else frames

    def evaluate(tag):
        frames[tag] = []
        ret = eval_one_epoch(model, test_loader, test_set, names, cfg,
                             device=args.device, per_frame=frames[tag])
        if args.infer_time:
            logger.info(f"{tag} inference: {ret['infer_time_ms']:.2f} ms "
                        f"a batch")
        return ret

    fp_ret = {}
    if not args.skip_fp_baseline:
        logger.info("== FP32 baseline eval ==")
        fp_ret = evaluate("fp")

    if args.deploy_int8:
        rules = quant_api.int8_deploy_recipe(sq=not args.no_sq,
                                             alpha=args.alpha,
                                             static=args.static)
    else:
        recipe_fn = {"centerpoint": quant_api.centerpoint_recipe,
                     "second": quant_api.second_recipe,
                     "pointpillar": quant_api.pointpillar_recipe,
                     "voxelnext": quant_api.voxelnext_recipe,
                     "transfusion": quant_api.transfusion_recipe}[recipe_name]
        rules = recipe_fn(w_bits=args.w_bits, act_bits=args.act_bits,
                          sq=not args.no_sq, alpha=args.alpha,
                          static=args.static)
    example = load_data_to_device(next(iter(test_loader)), device=args.device)
    quant_api.quantize_model(model, rules, example)
    if args.static:
        logger.info(f"== calibrating over {args.calib_batches} batches ==")
        quant_api.collect_stats(
            model, (load_data_to_device(b, device=args.device)
                    for b in test_loader), num_batches=args.calib_batches)
        quant_api.compute_amax(model, method=args.amax_method)
        logger.info(f"== amax resolved ({args.amax_method}) ==")

    logger.info("== quantized eval ==")
    q_ret = evaluate("quant")

    logger.info("== summary ==")
    for k in sorted(set(fp_ret) | set(q_ret)):
        logger.info(f"{k}: fp={fp_ret.get(k)} quant={q_ret.get(k)}")
    return fp_ret, q_ret


if __name__ == "__main__":
    run()
