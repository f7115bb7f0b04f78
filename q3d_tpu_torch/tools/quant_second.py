"""SECOND PTQ entry (port of ``tools/quant/quant_second.py``): the PTQ
driver with ``second_recipe``.

    python -m q3d_tpu_torch.tools.quant_second --cfg_file CFG [driver flags]
"""

from .quant_driver import run

if __name__ == "__main__":
    run("second")
