"""VoxelNeXt PTQ entry (port of ``tools/quant/quant_voxelnext.py``): the PTQ
driver with ``voxelnext_recipe``.

    python -m q3d_tpu_torch.tools.quant_voxelnext --cfg_file CFG [driver flags]
"""

from .quant_driver import run

if __name__ == "__main__":
    run("voxelnext")
