"""Training: one step, and the loop of epochs with checkpoints and resume
(port of ``q3d_tpu/parallel/mesh.py::make_train_step`` and
``q3d_tpu/train_utils.py::train_model``).

``train_step`` is ``make_train_step``'s step on one device: the forward in
train mode (batch statistics), ``loss.backward()`` (every sparse conv's
input gradient on kernel 1 over its inverse book), the step's own clip
``g * min(1, c / (|g| + 1e-6))``, then the optimizer's chain
(``optimization.Optimizer``, whose own ``clip_by_global_norm`` comes
first), so under ``train_model`` the gradient is clipped twice, as in the
reference.

QAT is training a model that ``quant.api.quantize_model`` put under a
fake-quant recipe first (the reference passes the rules to
``make_train_step`` because its rules are a scope around each apply; the
port attaches them to the layers once).  The quantizers' amax are buffers
and their scales are taken without gradient, so the straight-through
``fake_quant`` passes the gradient to the float weights and features.
"""

import time
from pathlib import Path

import torch

from .models import load_data_to_device
from .optimization import build_optimizer, global_norm
from .utils import checkpoint as ckpt_utils
from .utils.common_utils import AverageMeter

# the batch keys a training forward reads
MODEL_KEYS = ("voxels", "voxel_coords", "voxel_num_points", "gt_boxes")


def biases_before_bn(model):
    """Names of the conv biases that feed a BatchNorm directly (the head's
    convs under USE_BIAS_BEFORE_NORM).  In train mode their gradient is 0
    in exact arithmetic, since the BN takes out any per-channel constant,
    so what a step gives them is rounding noise."""
    from .models.layers import BatchNorm, Conv2d
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            kids = list(mod.named_children())
            for (n0, a), (_, b) in zip(kids, kids[1:]):
                if isinstance(a, Conv2d) and isinstance(b, BatchNorm) \
                        and a.bias is not None:
                    out.add(f"{name}.{n0}.bias")
    return out


def update(optimizer, grad_clip=10.0):
    """The step's own clip of the gradients (``make_train_step``:
    g * min(1, c / (|g| + 1e-6))), then the optimizer's update."""
    if grad_clip:
        grads = [p.grad for p in optimizer.params if p.grad is not None]
        norm = global_norm(grads)
        # a true division (``scalar / tensor`` multiplies by the reciprocal)
        scale = torch.div(norm.new_tensor(grad_clip),
                          norm + 1e-6).clamp_max(1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
    optimizer.step()


def train_step(model, batch, optimizer, grad_clip=10.0):
    """One training step on a device batch -> (loss, tb_dict), detached.
    The model fills a copy of ``batch``, which stays as it was."""
    model.train()
    optimizer.zero_grad()
    out = model(dict(batch))
    out["loss"].backward()
    update(optimizer, grad_clip)
    return out["loss"].detach(), {k: v.detach()
                                  for k, v in out.get("tb_dict", {}).items()}


def _disable_augmentation_hook(dataset, optim_cfg, epoch, total_epochs,
                               logger=None):
    """The reference's late-epoch augmentation switch-off
    (``HOOK.DisableAugmentationHook``): from ``NUM_LAST_EPOCHS`` (5)
    before the end, the dataset's augmentor is rebuilt with the hook's
    DISABLE_AUG_LIST (``gt_sampling`` by default) disabled."""
    hook_cfg = optim_cfg.get("HOOK", {}).get("DisableAugmentationHook", None)
    if not hook_cfg:
        return
    if epoch < total_epochs - int(hook_cfg.get("NUM_LAST_EPOCHS", 5)):
        return
    augmentor = getattr(dataset, "data_augmentor", None)
    if augmentor is None or not augmentor.data_augmentor_queue:
        return
    from .config import EDict
    configs = augmentor.augmentor_configs
    cfg = EDict({"DISABLE_AUG_LIST": list(hook_cfg.get(
        "DISABLE_AUG_LIST", ["gt_sampling"])),
        "AUG_CONFIG_LIST": list(configs if isinstance(configs, list)
                                else configs.AUG_CONFIG_LIST)})
    augmentor.disable_augmentation(cfg)
    if logger:
        logger.info(f"epoch {epoch}: disabled augmentations "
                    f"{cfg.DISABLE_AUG_LIST}")


def train_model(model, optim_cfg, train_loader, ckpt_dir, total_epochs,
                device=None, logger=None, ckpt_save_interval=1,
                max_ckpt_save_num=30):
    """Train ``model`` for ``total_epochs`` over ``train_loader`` (numpy
    batches, moved to ``device``), saving ``checkpoint_epoch_{n}.pth`` every
    ``ckpt_save_interval`` epochs (keeping ``max_ckpt_save_num``), resuming
    from the newest checkpoint in ``ckpt_dir`` if there is one.  Returns
    (optimizer, history): one dict per step (epoch, it, loss, lr, data_s,
    step_s)."""
    steps_per_epoch = len(train_loader)
    optimizer = build_optimizer(model.parameters(), optim_cfg,
                                steps_per_epoch * total_epochs)
    start_epoch = it = 0
    ckpt_dir = Path(ckpt_dir)
    latest = ckpt_utils.find_latest_checkpoint(ckpt_dir)
    if latest is not None:
        start_epoch, it = ckpt_utils.load_checkpoint(latest, model, optimizer)
        if logger:
            logger.info(f"resumed from {latest} at epoch {start_epoch}")
    grad_clip = float(optim_cfg.get("GRAD_NORM_CLIP", 10.0))
    data_meter, batch_meter = AverageMeter(), AverageMeter()
    history = []
    for epoch in range(start_epoch, total_epochs):
        train_loader.set_epoch(epoch)
        _disable_augmentation_hook(train_loader.dataset, optim_cfg, epoch,
                                   total_epochs, logger)
        end = time.time()
        for raw in train_loader:
            batch = load_data_to_device(
                {k: v for k, v in raw.items() if k in MODEL_KEYS}, device)
            data_meter.update(time.time() - end)
            lr = optimizer.lr(optimizer.count)
            loss, _ = train_step(model, batch, optimizer, grad_clip)
            loss = float(loss)
            it += 1
            batch_meter.update(time.time() - end)
            history.append({"epoch": epoch, "it": it, "loss": loss, "lr": lr,
                            "data_s": data_meter.val,
                            "step_s": batch_meter.val - data_meter.val})
            end = time.time()
            if logger and it % 20 == 0:
                logger.info(f"epoch {epoch} it {it} loss {loss:.4f} "
                            f"lr {lr:.2e} data {data_meter.avg:.3f}s "
                            f"batch {batch_meter.avg:.3f}s")
        if (epoch + 1) % ckpt_save_interval == 0:
            ckpt_utils.save_checkpoint(
                ckpt_dir / f"checkpoint_epoch_{epoch + 1}.pth", model,
                optimizer, epoch=epoch + 1, it=it,
                max_keep=max_ckpt_save_num)
            if logger:
                logger.info(f"saved checkpoint_epoch_{epoch + 1}")
    return optimizer, history
