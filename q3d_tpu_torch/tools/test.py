"""Evaluation CLI (port of ``tools/test.py``): one checkpoint's eval.

    python -m q3d_tpu_torch.tools.test --cfg_file CFG [--ckpt CKPT]
        [--quant none|fake|int8] [--bf16] [--infer_time] [--device cpu]
        [--set KEY VALUE ...]

``--quant fake`` runs ``centerpoint_recipe()`` (dynamic SmoothQuant
fake-quant), ``--quant int8`` runs ``int8_deploy_recipe()`` (dynamic
per-tensor int8, no residency), as ``tools/test.py:80`` does.  ``--ckpt``
takes the reference's native checkpoint or a pcdet ``.pth`` (such as the
``checkpoint_epoch_{n}.pth`` files of ``tools/train.py``).  Not ported
(``ROADMAP.md``): ``--eval_all``, the checkpoint watcher, and
``--save_to_file``, the result files.
"""

import argparse


def parse_config(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--infer_time", action="store_true")
    parser.add_argument("--save_to_file", action="store_true")
    parser.add_argument("--quant", choices=["none", "fake", "int8"],
                        default="none")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--eval_all", action="store_true",
                        help="watch --ckpt_dir and evaluate checkpoints as "
                             "they appear (reference repeat_eval_ckpt)")
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (the plain versions)")
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from ..config import EDict, cfg_from_list, cfg_from_yaml_file
    cfg = cfg_from_yaml_file(args.cfg_file, EDict())
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def main(argv=None):
    """Evaluate as the command line (or ``argv``) asks -> the metrics."""
    args, cfg = parse_config(argv)
    if args.eval_all:
        raise NotImplementedError(
            "--eval_all (the checkpoint watcher) is not ported yet "
            "(ROADMAP.md)")
    if args.save_to_file:
        raise NotImplementedError("--save_to_file (result files) is not "
                                  "ported (ROADMAP.md)")
    import torch

    from ..datasets import build_dataloader
    from ..eval_utils import eval_one_epoch
    from ..models import build_network, load_data_to_device
    from ..quant.api import (centerpoint_recipe, int8_deploy_recipe,
                             quantize_model)
    from ..utils import common_utils
    from ..utils.checkpoint import load_params_from_file

    logger = common_utils.create_logger()
    test_set, test_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, args.batch_size, training=False)
    names = list(cfg.CLASS_NAMES)
    model = build_network(cfg.MODEL, len(names), test_set, device=args.device)
    if args.ckpt:
        load_params_from_file(model, args.ckpt, logger=logger)
    rules = {"none": None, "fake": centerpoint_recipe,
             "int8": int8_deploy_recipe}[args.quant]
    dtype = torch.bfloat16 if args.bf16 else None
    if rules is not None:
        quantize_model(model, rules(), load_data_to_device(
            next(iter(test_loader)), device=args.device, compute_dtype=dtype))
    ret = eval_one_epoch(model, test_loader, test_set, names, cfg,
                         device=args.device, compute_dtype=dtype)
    if args.infer_time:
        logger.info(f"inference: {ret['infer_time_ms']:.2f} ms a batch")
    logger.info(f"eval result [{args.extra_tag}]: {ret}")
    return ret


if __name__ == "__main__":
    main()
