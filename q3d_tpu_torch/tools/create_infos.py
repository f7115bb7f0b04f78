"""Dataset preparation CLI (port of ``tools/create_infos.py``): the info
pickles and the gt databases the datasets and the augmentor's gt sampling
read.

    python -m q3d_tpu_torch.tools.create_infos kitti \\
        --cfg_file tools/cfgs/dataset_configs/kitti_dataset.yaml \\
        --data_path DATA [--save_path OUT] [--with_gt_database]
    python -m q3d_tpu_torch.tools.create_infos nuscenes \\
        --cfg_file tools/cfgs/dataset_configs/nuscenes_dataset.yaml \\
        --data_path DATA [--version v1.0-trainval] [--max_sweeps N]
        [--with_gt_database | --gt_database_only]

``kitti``: ``kitti_infos_{train,val,test}.pkl`` for each split listed
under ``ImageSets/``, and with ``--with_gt_database`` the train split's
``gt_database_train/`` and ``kitti_dbinfos_train.pkl``.  ``nuscenes``: the
info pickles of ``DATA/<version>`` from the devkit's tables (needs the
``nuscenes`` devkit, as the reference does), and with ``--with_gt_database``
the gt database from the train infos; ``--gt_database_only`` builds the
database from info pickles already there, without the devkit.  The other
datasets of the reference's CLI are not ported yet (``ROADMAP.md``).
"""

import argparse
from pathlib import Path

KITTI_CLASSES = ["Car", "Pedestrian", "Cyclist"]
NUSCENES_CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer",
                    "barrier", "motorcycle", "bicycle", "pedestrian",
                    "traffic_cone"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset",
                        choices=["kitti", "nuscenes", "waymo", "once",
                                 "lyft", "argo2", "pandaset", "custom",
                                 "integrated"])
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--save_path", default=None)
    parser.add_argument("--with_gt_database", action="store_true")
    parser.add_argument("--gt_database_only", action="store_true",
                        help="nuscenes only: the gt database from the info "
                             "pickles already under DATA/<version>")
    parser.add_argument("--version", default="v1.0-trainval",
                        help="nuscenes only")
    parser.add_argument("--max_sweeps", type=int, default=None,
                        help="nuscenes only (default: the config's "
                             "MAX_SWEEPS)")
    return parser.parse_args(argv)


def main(argv=None):
    """Prepare the dataset as the command line (or ``argv``) asks -> what
    was written: {"infos": {split or path: count or path}, "gt_database":
    the db-info pickle's path or None}."""
    args = parse_args(argv)
    if args.dataset not in ("kitti", "nuscenes"):
        raise NotImplementedError(
            f"create_infos {args.dataset}: only kitti and nuscenes are "
            f"ported to q3d_tpu_torch yet (ROADMAP.md, queue 1 #6)")
    from ..config import EDict, cfg_from_yaml_file
    cfg = cfg_from_yaml_file(args.cfg_file, EDict())
    save_path = args.save_path or args.data_path
    out = {"infos": {}, "gt_database": None}

    if args.dataset == "kitti":
        from ..datasets.kitti.kitti_dataset import (KittiDataset,
                                                     create_kitti_infos)
        out["infos"] = create_kitti_infos(cfg, KITTI_CLASSES, args.data_path,
                                          save_path)
        print(f"kitti infos -> {save_path}: {out['infos']}")
        if args.with_gt_database:
            ds = KittiDataset(dataset_cfg=cfg, class_names=KITTI_CLASSES,
                              root_path=args.data_path, training=False)
            out["gt_database"] = ds.create_groundtruth_database(
                Path(save_path) / "kitti_infos_train.pkl",
                used_classes=KITTI_CLASSES, split="train")
            print(f"gt database -> {out['gt_database']}")
        return out

    from ..datasets.nuscenes.nuscenes_dataset import NuScenesDataset
    from ..datasets.nuscenes.nuscenes_infos import (
        create_groundtruth_database, create_nuscenes_info)
    max_sweeps = args.max_sweeps or int(cfg.get("MAX_SWEEPS", 10))
    if not args.gt_database_only:
        paths = create_nuscenes_info(args.version, args.data_path, save_path,
                                     max_sweeps=max_sweeps)
        out["infos"] = {str(p): str(p) for p in paths}
        print("info pickles:", ", ".join(str(p) for p in paths))
    if (args.with_gt_database or args.gt_database_only) \
            and args.version != "v1.0-test":
        names = list(cfg.get("CLASS_NAMES", NUSCENES_CLASSES))
        ds = NuScenesDataset(dataset_cfg=cfg, class_names=names,
                             root_path=Path(save_path) / args.version,
                             training=True)
        ds.include_nuscenes_data("train")       # the infos, without CBGS
        out["gt_database"] = create_groundtruth_database(
            ds, max_sweeps=max_sweeps)
        print(f"gt database -> {out['gt_database']}")
    return out


if __name__ == "__main__":
    main()
