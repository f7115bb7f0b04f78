"""The config-queued data augmentor (port of
``q3d_tpu/datasets/augmentor/data_augmentor.py``): ``gt_sampling``, the
world flips, rotation, scaling and translation, the per-object and
frustum steps, the pyramid steps and the image flip, in the order of
``AUG_CONFIG_LIST`` less ``DISABLE_AUG_LIST``; ``disable_augmentation``
rebuilds the queue with more steps disabled (the late-epoch hook).

Every random draw comes from ``rng`` (a ``np.random.RandomState``); by
default numpy's global one, which the reference draws from and
``common_utils.set_random_seed`` seeds.
"""

from functools import partial

import numpy as np

from ...utils import common_utils
from . import augmentor_utils


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None,
                 rng=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.rng = rng if rng is not None else np.random.mtrand._rand
        self.augmentor_configs = augmentor_configs
        self.data_augmentor_queue = []
        aug_list = augmentor_configs if isinstance(augmentor_configs, list) \
            else augmentor_configs.AUG_CONFIG_LIST
        disable = [] if isinstance(augmentor_configs, list) \
            else list(augmentor_configs.get("DISABLE_AUG_LIST", []))
        for cfg in aug_list:
            if cfg.NAME in disable:
                continue
            self.data_augmentor_queue.append(
                getattr(self, cfg.NAME)(config=cfg))

    def disable_augmentation(self, augmentor_configs):
        """Rebuild the queue from ``augmentor_configs`` (the late-epoch
        hook's, with more steps in DISABLE_AUG_LIST)."""
        self.__init__(self.root_path, augmentor_configs, self.class_names,
                      self.logger, self.rng)

    # ------------------------------ steps ---------------------------------

    def gt_sampling(self, config=None):
        from .database_sampler import DataBaseSampler
        return DataBaseSampler(root_path=self.root_path, sampler_cfg=config,
                               class_names=self.class_names,
                               logger=self.logger, rng=self.rng)

    def random_world_flip(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        for axis in config.ALONG_AXIS_LIST:
            fn = getattr(augmentor_utils, f"random_flip_along_{axis}")
            data_dict["gt_boxes"], data_dict["points"], enable = fn(
                data_dict["gt_boxes"], data_dict["points"], self.rng)
            data_dict[f"flip_{axis}"] = enable
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config.WORLD_ROT_ANGLE
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        data_dict["gt_boxes"], data_dict["points"], angle = \
            augmentor_utils.global_rotation(
                data_dict["gt_boxes"], data_dict["points"], rot_range,
                self.rng)
        data_dict["noise_rot"] = angle
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        data_dict["gt_boxes"], data_dict["points"], scale = \
            augmentor_utils.global_scaling(
                data_dict["gt_boxes"], data_dict["points"],
                config.WORLD_SCALE_RANGE, self.rng)
        data_dict["noise_scale"] = scale
        return data_dict

    def random_world_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_translation, config=config)
        data_dict["gt_boxes"], data_dict["points"], _ = \
            augmentor_utils.global_translation(
                data_dict["gt_boxes"], data_dict["points"],
                config.NOISE_TRANSLATE_STD, self.rng)
        return data_dict

    def _per_axis(self, data_dict, prefix, axes, *args):
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        for axis in axes:
            gt_boxes, points = getattr(augmentor_utils, prefix + axis)(
                gt_boxes, points, *args, self.rng)
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_local_translation(self, data_dict=None, config=None):
        """Per-object translation along the configured axes."""
        if data_dict is None:
            return partial(self.random_local_translation, config=config)
        axes = config["ALONG_AXIS_LIST"]
        assert all(a in ("x", "y", "z") for a in axes), axes
        return self._per_axis(data_dict, "random_local_translation_along_",
                              axes, config["LOCAL_TRANSLATION_RANGE"])

    def random_local_rotation(self, data_dict=None, config=None):
        """Per-object rotation about its own centre."""
        if data_dict is None:
            return partial(self.random_local_rotation, config=config)
        rot_range = config["LOCAL_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        data_dict["gt_boxes"], data_dict["points"] = \
            augmentor_utils.local_rotation(
                data_dict["gt_boxes"], data_dict["points"], rot_range,
                self.rng)
        return data_dict

    def random_local_scaling(self, data_dict=None, config=None):
        """Per-object scaling about its centre."""
        if data_dict is None:
            return partial(self.random_local_scaling, config=config)
        data_dict["gt_boxes"], data_dict["points"] = \
            augmentor_utils.local_scaling(
                data_dict["gt_boxes"], data_dict["points"],
                config["LOCAL_SCALE_RANGE"], self.rng)
        return data_dict

    def random_world_frustum_dropout(self, data_dict=None, config=None):
        """Scene-level slab dropout per direction."""
        if data_dict is None:
            return partial(self.random_world_frustum_dropout, config=config)
        dirs = config["DIRECTION"]
        assert all(d in ("top", "bottom", "left", "right") for d in dirs)
        return self._per_axis(data_dict, "global_frustum_dropout_", dirs,
                              config["INTENSITY_RANGE"])

    def random_local_frustum_dropout(self, data_dict=None, config=None):
        """Per-object slab dropout per direction."""
        if data_dict is None:
            return partial(self.random_local_frustum_dropout, config=config)
        dirs = config["DIRECTION"]
        assert all(d in ("top", "bottom", "left", "right") for d in dirs)
        return self._per_axis(data_dict, "local_frustum_dropout_", dirs,
                              config["INTENSITY_RANGE"])

    def random_local_pyramid_aug(self, data_dict=None, config=None):
        """SE-SSD pyramid dropout, then sparsify, then swap."""
        if data_dict is None:
            return partial(self.random_local_pyramid_aug, config=config)
        gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
        gt_boxes, points, pyramids = augmentor_utils.local_pyramid_dropout(
            gt_boxes, points, config["DROP_PROB"], self.rng)
        gt_boxes, points, pyramids = augmentor_utils.local_pyramid_sparsify(
            gt_boxes, points, config["SPARSIFY_PROB"],
            config["SPARSIFY_MAX_NUM"], self.rng, pyramids)
        gt_boxes, points = augmentor_utils.local_pyramid_swap(
            gt_boxes, points, config["SWAP_PROB"], config["SWAP_MAX_NUM"],
            self.rng, pyramids)
        data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
        return data_dict

    def random_image_flip(self, data_dict=None, config=None):
        """Horizontal flip of the images and depth maps (camera models)."""
        if data_dict is None:
            return partial(self.random_image_flip, config=config)
        for axis in config["ALONG_AXIS_LIST"]:
            assert axis == "horizontal"
            enable = self.rng.rand() < 0.5
            data_dict["image_flip"] = int(enable)
            if not enable:
                continue
            for key in ("images", "depth_maps"):
                if key in data_dict:
                    data_dict[key] = np.ascontiguousarray(
                        data_dict[key][:, ::-1])
        return data_dict

    # ------------------------------ driver --------------------------------

    def forward(self, data_dict):
        """Run the queue, wrap the headings into [-pi, pi), then apply
        ``gt_boxes_mask`` (the class filter) to the boxes and names."""
        for step in self.data_augmentor_queue:
            data_dict = step(data_dict=data_dict)
        gt = data_dict.get("gt_boxes", None)
        if gt is not None and len(gt):
            data_dict["gt_boxes"][:, 6] = common_utils.limit_period(
                data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi)
        if "gt_boxes_mask" in data_dict:
            mask = data_dict.pop("gt_boxes_mask")
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
            data_dict["gt_names"] = data_dict["gt_names"][mask]
        return data_dict
