"""PointPillars PTQ entry (port of ``tools/quant/quant_pointpillar.py``):
the PTQ driver with ``pointpillar_recipe``.

    python -m q3d_tpu_torch.tools.quant_pointpillar --cfg_file CFG [driver flags]
"""

from .quant_driver import run

if __name__ == "__main__":
    run("pointpillar")
