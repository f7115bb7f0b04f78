"""RoIHeadTemplate — the second stage's shared parts (port of
``q3d_tpu/models/roi_heads/roi_head_template.py``, inference): the box
coder (``_coder`` :31), the refinement MLPs (shared FC + BN + ReLU, then
the cls and reg FCs; the reference's heads write them out each), the
decode of the reg branch in each ROI's canonical frame (``decode_boxes``
:96) and the final outputs.  A refined box is scored sigmoid(rcnn) x the
ROI's score, and no NMS follows, as in the reference (``ROADMAP.md`` §3).
The targets, their encoding and the losses (``assign_targets``,
``encode_targets``, ``get_loss``) come with training."""

import torch
from torch import nn

from ...utils import box_coder_utils, common_utils
from ..backbones_3d.pfe.voxel_set_abstraction import f32_batch_norm
from ..layers import Linear


class RoIHeadTemplate(nn.Module):
    def __init__(self, model_cfg, pooled_channels):
        super().__init__()
        self.model_cfg = model_cfg
        self.box_coder = box_coder_utils.ResidualCoder(
            **model_cfg.TARGET_CONFIG.get("BOX_CODER_CONFIG", {}))
        cin = pooled_channels
        self.num_shared = len(model_cfg.SHARED_FC)
        for i, c in enumerate(model_cfg.SHARED_FC):
            self.add_module(f"shared_fc_{i}", Linear(cin, c, bias=False))
            self.add_module(f"shared_norm_{i}", f32_batch_norm(c))
            cin = c
        for branch, out in (("cls", 1), ("reg", self.box_coder.code_size)):
            c_in = cin
            for i, c in enumerate(model_cfg[f"{branch.upper()}_FC"]):
                self.add_module(f"{branch}_fc_{i}", Linear(c_in, c))
                c_in = c
            self.add_module(f"{branch}_out", Linear(c_in, out))

    def _branch(self, x, branch):
        for i in range(len(self.model_cfg[f"{branch.upper()}_FC"])):
            x = torch.relu(getattr(self, f"{branch}_fc_{i}")(x))
        return getattr(self, f"{branch}_out")(x)

    def refine(self, pooled):
        """(B * R, pooled) -> (cls_preds (B * R, 1), box_preds (B * R,
        code))."""
        x = pooled
        for i in range(self.num_shared):
            x = torch.relu(getattr(self, f"shared_norm_{i}")(
                getattr(self, f"shared_fc_{i}")(x)))
        return self._branch(x, "cls"), self._branch(x, "reg")

    def decode_boxes(self, rois, box_preds):
        """The reg branch's residuals in each ROI's canonical frame ->
        boxes in the world frame (B, R, 7)."""
        zeros = torch.zeros_like(rois[..., 0:3])
        local_roi = torch.cat([zeros, rois[..., 3:6], zeros[..., :1]], dim=-1)
        local = self.box_coder.decode(box_preds, local_roi)
        shape = local.shape
        xyz = common_utils.rotate_points_along_z(
            local[..., None, 0:3].reshape(-1, 1, 3),
            rois[..., 6].reshape(-1)).reshape(*shape[:-1], 3)
        return torch.cat([xyz + rois[..., 0:3], local[..., 3:6],
                          local[..., 6:7] + rois[..., 6:7]], dim=-1)

    def finish(self, batch_dict, rois, pooled):
        """The refinement of ``pooled`` (B * R, C) and the final outputs."""
        if self.training:
            raise NotImplementedError(
                f"{type(self).__name__}: the ROI targets and losses come "
                f"with two-stage training")
        b, r = rois.shape[:2]
        cls_preds, box_preds = self.refine(pooled)
        scores = torch.sigmoid(cls_preds.reshape(b, r))
        batch_dict["final_boxes"] = self.decode_boxes(
            rois, box_preds.reshape(b, r, -1))
        batch_dict["final_scores"] = scores * batch_dict["roi_scores"]
        batch_dict["final_labels"] = batch_dict["roi_labels"]
        batch_dict["final_valid"] = batch_dict["roi_valid"]
        return batch_dict
