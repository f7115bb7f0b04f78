"""How far a whole QAT step of the port lies from the reference's, and how
far a last-bit change of its input moves it: the readings behind the
limits of ``test_torch_port_train_step.py::test_train_step_matches_reference
[qat]`` and ``chip_smoke.py``'s ``QAT_TOL``.

The trained tiny CenterPoint fixture on both sides, one step of the
reference's ``make_train_step`` under ``centerpoint_recipe()`` (sgd, clip
10), then the port's ``train_step`` under ``centerpoint_recipe()``:
  * as it is;
  * with its voxels multiplied by (1 + 1e-7 * N(0, 1)), one seed each;
  * under faults: no fake-quant, SmoothQuant off, 4-bit weights;
each against the reference's step (loss relative difference, and the
gradients' global relative L2 difference and cosine over every tensor but
the conv biases before a train-mode BN); and the perturbed port against
itself.  One JSON line per reading.  On the CPU (a few minutes):

    JAX_PLATFORMS=cpu python tests/torch_port_qat_spread.py [--batch-size 1]
"""

import argparse
import json
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import conftest  # noqa: E402,F401  (the CPU platform, as the tests run)
import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_port_train_step as T  # noqa: E402
from q3d_tpu.quant import api as jax_quant  # noqa: E402
from q3d_tpu.models import load_data_to_device as jax_device  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--self-seeds", type=int, default=3)
    args = ap.parse_args()
    torch.set_num_threads(2)
    _, _, jloader, jmodel = T._jax_model("centerpoint_tiny",
                                         batch_size=args.batch_size)
    raw = {k: v for k, v in next(iter(jloader)).items() if k in T.MODEL_KEYS}
    with open(T.CKPT, "rb") as f:
        variables = T._np(flax.serialization.msgpack_restore(
            pickle.load(f)["model_state"]))
    tx = T._recording(T.jax_build_optimizer(T.JaxEDict(T.SGD), 3)[0])
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    step = T.make_train_step(jmodel, tx, grad_clip=10.0,
                             rules=jax_quant.centerpoint_recipe())
    _, state, loss, _ = step(v, tx.init(v["params"]), jax_device(raw))
    want = {"loss": float(loss), "grads": T._np(state["g"])}

    def port(recipe, seed=None):
        model = T._port(variables)
        batch = T.load_data_to_device(raw, device="cpu")
        if seed is not None:
            g = torch.Generator().manual_seed(seed)
            batch["voxels"] = batch["voxels"] * (1 + 1e-7 * torch.randn(
                batch["voxels"].shape, generator=g))
        if recipe is not None:
            T.port_quant.quantize_model(model, recipe, batch)
        opt = T.build_optimizer(model.parameters(), T.EDict(T.SGD), 3)
        loss, _ = T.train_step(model, batch, opt, grad_clip=10.0)
        return model, float(loss)

    def against(name, model, loss, ref_loss, ref_grads):
        _, rel_l2, cos = T._grad_errors(model, ref_grads,
                                        T.biases_before_bn(model))
        print(json.dumps({"reading": name, "batch": args.batch_size,
                          "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                          "rel_l2": rel_l2, "cos": cos}), flush=True)

    recipe = T.port_quant.centerpoint_recipe
    against("port_vs_reference", *port(recipe()), want["loss"],
            want["grads"])
    for s in range(1, args.seeds + 1):
        against(f"perturbed_seed{s}_vs_reference", *port(recipe(), s),
                want["loss"], want["grads"])
    for name, r in (("no_fakequant", None), ("no_smoothquant",
                                             recipe(sq=False)),
                    ("weights_4bit", recipe(w_bits=4))):
        against(f"fault_{name}_vs_reference", *port(r), want["loss"],
                want["grads"])
    base, base_loss = port(recipe())
    zero = T.biases_before_bn(base)
    ref = {n: p.grad for n, p in base.named_parameters() if n not in zero}
    for s in range(1, args.self_seeds + 1):
        model, loss = port(recipe(), s)
        got = {n: p.grad for n, p in model.named_parameters() if n in ref}
        num = sum(float((got[n] - g).pow(2).sum()) for n, g in ref.items())
        den = sum(float(g.pow(2).sum()) for g in ref.values())
        dot = sum(float((got[n] * g).sum()) for n, g in ref.items())
        mine = sum(float(g.pow(2).sum()) for g in got.values())
        print(json.dumps({"reading": f"perturbed_seed{s}_vs_port",
                          "batch": args.batch_size,
                          "loss_rel": abs(loss - base_loss) / abs(base_loss),
                          "rel_l2": (num / den) ** 0.5,
                          "cos": dot / (den * mine) ** 0.5}), flush=True)


if __name__ == "__main__":
    main()
