"""RoIHeadTemplate — the second stage's shared parts (port of
``q3d_tpu/models/roi_heads/roi_head_template.py``): the box coder
(``_coder`` :31), the refinement MLPs (shared FC + BN + ReLU, then the cls
and reg FCs; the reference's heads write them out each), the decode of the
reg branch in each ROI's canonical frame (``decode_boxes`` :96) and the
final outputs.  A refined box is scored sigmoid(rcnn) x the ROI's score,
and no NMS follows, as in the reference (``ROADMAP.md`` §3).

Training (``assign_targets`` :37, ``encode_targets`` :75, ``get_loss``
:110): each proposal's best same-class valid gt by 3D IoU; ROI_PER_IMAGE
rois a frame picked by a deterministic top-K, as the reference picks them
(FG_RATIO of them by the highest IoU at or above REG_FG_THRESH, the rest
by the highest below it; ties at the lowest index, as ``lax.top_k``; the
rois' ``roi_valid`` is not read); the IoU-guided classification target
clip((iou - CLS_BG_THRESH) / (CLS_FG_THRESH - CLS_BG_THRESH), 0, 1) under
a binary cross-entropy averaged over the rois, and the smooth-L1 of the
residuals in each roi's canonical frame over the rois at or above
REG_FG_THRESH.  The targets carry no gradient: the proposals come out of
the proposal layer without one (``Detector3DTemplate.proposal_layer``).
CORNER_LOSS_REGULARIZATION, CLS_BG_THRESH_LO, HARD_BG_RATIO,
SAMPLE_ROI_BY_EACH_CLASS and DP_RATIO are not read, as in the reference
(``ROADMAP.md`` §3)."""

import torch
from torch import nn

from ...ops.iou3d_nms import boxes_iou3d
from ...utils import box_coder_utils, common_utils, loss_utils
from ..model_utils.model_nms_utils import stable_top
from ..backbones_3d.pfe.voxel_set_abstraction import f32_batch_norm
from ..layers import Linear


class RoIHeadTemplate(nn.Module):
    # the branches after the shared FCs, each ``<branch>_fc_<i>`` (ReLU)
    # then ``<branch>_out``: the rcnn score (1) and the box residuals
    BRANCHES = ("cls", "reg")

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
        for branch in self.BRANCHES:
            out = self.box_coder.code_size if branch == "reg" else 1
            c_in = cin
            for i, c in enumerate(model_cfg[f"{branch.upper()}_FC"]):
                self.add_module(f"{branch}_fc_{i}", Linear(c_in, c))
                c_in = c
            self.add_module(f"{branch}_out", Linear(c_in, out))

    def _branch(self, x, branch):
        for i in range(len(self.model_cfg[f"{branch.upper()}_FC"])):
            x = torch.relu(getattr(self, f"{branch}_fc_{i}")(x))
        return getattr(self, f"{branch}_out")(x)

    def shared(self, pooled):
        """The shared FCs (Linear, BN, ReLU) over (B * R, pooled) rows."""
        x = pooled
        for i in range(self.num_shared):
            x = torch.relu(getattr(self, f"shared_norm_{i}")(
                getattr(self, f"shared_fc_{i}")(x)))
        return x

    def refine(self, pooled):
        """(B * R, pooled) -> (cls_preds (B * R, 1), box_preds (B * R,
        code))."""
        x = self.shared(pooled)
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

    def assign_targets(self, rois, roi_labels, gt_boxes):
        """rois (B, R, 7), roi_labels (B, R) 1-based, gt_boxes (B, M, 8) ->
        dict of the ROI_PER_IMAGE sampled rows a frame: ``rois`` (B, S,
        7), their ``gt`` (B, S, 8), classification target ``cls_target``
        and ``reg_valid`` (B, S)."""
        cfg = self.model_cfg.TARGET_CONFIG
        s = int(cfg.ROI_PER_IMAGE)
        fg_num = int(s * float(cfg.FG_RATIO))
        reg_thresh = float(cfg.REG_FG_THRESH)
        gt_cls = gt_boxes[..., -1].long()
        iou = boxes_iou3d(rois, gt_boxes[..., :7])                # (B, R, M)
        same = (roi_labels.long()[..., :, None] == gt_cls[..., None, :]) \
            & (gt_cls > 0)[..., None, :]
        iou = torch.where(same, iou, torch.zeros_like(iou))
        # argmax: the first of the maxima, as the reference's
        max_iou, gt_idx = iou.amax(dim=2), iou.argmax(dim=2)
        minus = torch.full_like(max_iou, -1.0)
        _, fg_sel = stable_top(
            torch.where(max_iou >= reg_thresh, max_iou, minus), fg_num)
        _, bg_sel = stable_top(
            torch.where(max_iou < reg_thresh, max_iou, minus), s - fg_num)
        sel = torch.cat([fg_sel, bg_sel], dim=1)
        s_iou = max_iou.gather(1, sel)
        s_gt = gt_boxes.gather(1, gt_idx.gather(1, sel)[..., None].expand(
            -1, -1, gt_boxes.shape[-1]))
        fg, bg = float(cfg.CLS_FG_THRESH), float(cfg.CLS_BG_THRESH)
        # a true division (``tensor / scalar`` multiplies by the reciprocal
        # on the card)
        cls_target = torch.div(s_iou - bg, s_iou.new_tensor(fg - bg)) \
            .clamp(0.0, 1.0)
        return {"rois": rois.gather(1, sel[..., None].expand(-1, -1, 7)),
                "gt": s_gt, "cls_target": cls_target,
                "reg_valid": s_iou >= reg_thresh}

    def encode_targets(self, rois, gt_of_roi):
        """The gt boxes' residuals in each roi's canonical frame (the roi's
        centre at the origin, its heading 0)."""
        roi_ry = rois[..., 6]
        gt_local = torch.cat([gt_of_roi[..., 0:3] - rois[..., 0:3],
                              gt_of_roi[..., 3:7]], dim=-1)
        shape = gt_local.shape
        rot = common_utils.rotate_points_along_z(
            gt_local[..., None, 0:3].reshape(-1, 1, 3),
            -roi_ry.reshape(-1)).reshape(*shape[:-1], 3)
        gt_local = torch.cat([rot, gt_local[..., 3:6],
                              gt_local[..., 6:7] - roi_ry[..., None]], dim=-1)
        zeros = torch.zeros_like(rois[..., 0:3])
        local_roi = torch.cat([zeros, rois[..., 3:6], zeros[..., :1]], dim=-1)
        return self.box_coder.encode(gt_local, local_roi)

    def get_loss(self, cls_preds, box_preds, targets):
        """cls_preds (B, S), box_preds (B, S, code) of the sampled rois ->
        (rcnn_cls_loss, rcnn_reg_loss)."""
        lw = self.model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
        # max(x, 0) written (x + |x|) / 2 (the same values), so that at x =
        # 0 the gradient is the true sigmoid(0) - target, as in
        # loss_utils.sigmoid_focal_cls_loss (the reference's clip and abs
        # give -target there: ROADMAP.md §3)
        bce = (cls_preds + cls_preds.abs()) / 2 \
            - cls_preds * targets["cls_target"] \
            + torch.log1p(torch.exp(-cls_preds.abs()))
        cls_loss = bce.mean() * lw["rcnn_cls_weight"]
        reg_t = self.encode_targets(targets["rois"], targets["gt"])
        smooth = loss_utils.WeightedSmoothL1Loss(
            code_weights=lw.get("code_weights", None))
        w = targets["reg_valid"].float()
        reg_loss = smooth(box_preds, reg_t, w).sum() \
            / w.sum().clamp_min(1.0) * lw["rcnn_reg_weight"]
        return cls_loss, reg_loss

    def pooled_rois(self, batch_dict):
        """The rois the head pools around: the proposals, or in training
        the sampled ones (their targets kept for ``finish``)."""
        rois = batch_dict["rois"][..., :7]
        if not self.training:
            return rois
        with torch.no_grad():
            targets = self.assign_targets(rois, batch_dict["roi_labels"],
                                          batch_dict["gt_boxes"].float())
        batch_dict["rcnn_targets"] = targets
        return targets["rois"]

    def finish(self, batch_dict, rois, pooled):
        """The refinement of ``pooled`` (B * R, C): in training the losses,
        else the final outputs."""
        b, r = rois.shape[:2]
        cls_preds, box_preds = self.refine(pooled)
        if self.training:
            cls_loss, reg_loss = self.get_loss(
                cls_preds.reshape(b, r), box_preds.reshape(b, r, -1),
                batch_dict.pop("rcnn_targets"))
            batch_dict["loss"] = batch_dict.get("loss", 0.0) \
                + (cls_loss + reg_loss)
            batch_dict["tb_dict"] = {**batch_dict.get("tb_dict", {}),
                                     "rcnn_cls_loss": cls_loss,
                                     "rcnn_reg_loss": reg_loss}
            return batch_dict
        scores = torch.sigmoid(cls_preds.reshape(b, r))
        batch_dict["final_boxes"] = self.decode_boxes(
            rois, box_preds.reshape(b, r, -1))
        batch_dict["final_scores"] = scores * batch_dict["roi_scores"]
        batch_dict["final_labels"] = batch_dict["roi_labels"]
        batch_dict["final_valid"] = batch_dict["roi_valid"]
        return batch_dict
