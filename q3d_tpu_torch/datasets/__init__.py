"""Dataset registry + loader construction (port of
``q3d_tpu/datasets/__init__.py``): a plain Python iterator with the
static-shape ``collate_batch``; batches stay numpy until
``models.load_data_to_device``."""

import numpy as np

from .dataset import DatasetTemplate
from .kitti.kitti_dataset import KittiDataset
from .nuscenes.nuscenes_dataset import NuScenesDataset
from .synthetic_dataset import SyntheticDataset

_REGISTRY = {"DatasetTemplate": DatasetTemplate,
             "KittiDataset": KittiDataset,
             "NuScenesDataset": NuScenesDataset,
             "SyntheticDataset": SyntheticDataset}


class SimpleLoader:
    """Epoch iterator with batching + collate."""

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, e):
        self.epoch = e

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            samples = [self.dataset[j] for j in chunk]
            yield self.dataset.collate_batch(samples)


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None,
                     logger=None, training=True, seed=None):
    """-> (dataset, loader, None); raises on a dataset the port does not
    read yet (ROADMAP.md)."""
    if dataset_cfg.DATASET not in _REGISTRY:
        raise KeyError(f"dataset {dataset_cfg.DATASET} is not ported to "
                       f"q3d_tpu_torch yet (ROADMAP.md); it reads "
                       f"{sorted(_REGISTRY)}")
    dataset_cls = _REGISTRY[dataset_cfg.DATASET]
    dataset = dataset_cls(dataset_cfg=dataset_cfg, class_names=class_names,
                          root_path=root_path, training=training, logger=logger)
    loader = SimpleLoader(dataset, batch_size, shuffle=training,
                          drop_last=training, seed=seed or 0)
    return dataset, loader, None
