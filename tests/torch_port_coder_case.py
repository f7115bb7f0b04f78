"""Both packages' ``ResidualCoder`` on one seeded set of boxes and anchors,
both forms, in a fresh interpreter, for
``test_torch_port_anchor.py::test_residual_coder_matches_reference``:

    python tests/torch_port_coder_case.py OUT_DIR

writes ``OUT_DIR/coder_{False,True}.npz``: the boxes, each side's encoding,
each side's decoding of the reference's encoding, the code sizes."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from q3d_tpu.utils import box_coder_utils as jax_coder  # noqa: E402
from q3d_tpu_torch.utils import box_coder_utils as port_coder  # noqa: E402


def _residual_coder_case(sincos, out):
    """Both packages' ResidualCoder on one seeded set of boxes and anchors
    -> ``out`` (.npz): the inputs, each side's encoding, each side's
    decoding of the reference's encoding, the code sizes."""
    rng = np.random.RandomState(3)
    n = 4096
    anchors = np.concatenate([rng.uniform(-40, 40, (n, 3)),
                              rng.uniform(0.3, 5, (n, 3)),
                              rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    boxes = anchors + np.concatenate([rng.normal(0, 1, (n, 3)),
                                      rng.uniform(-0.2, 0.2, (n, 3)),
                                      rng.normal(0, 1, (n, 1))], 1)
    anchors, boxes = anchors.astype(np.float32), boxes.astype(np.float32)
    jc = jax_coder.ResidualCoder(encode_angle_by_sincos=sincos)
    pc = port_coder.ResidualCoder(encode_angle_by_sincos=sincos)
    enc = np.asarray(jc.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    ours = pc.encode(torch.from_numpy(boxes), torch.from_numpy(anchors))
    dec = np.asarray(jc.decode(jnp.asarray(enc), jnp.asarray(anchors)))
    ours_dec = pc.decode(torch.from_numpy(enc.copy()),
                         torch.from_numpy(anchors))
    np.savez(out, boxes=boxes, enc=enc, ours=ours.numpy(), dec=dec,
             ours_dec=ours_dec.numpy(),
             sizes=np.array([pc.code_size, jc.code_size]))


if __name__ == "__main__":
    for sincos in (False, True):
        _residual_coder_case(sincos, Path(sys.argv[1]) / f"coder_{sincos}.npz")
