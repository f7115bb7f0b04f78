"""TransFusion PTQ entry (port of ``tools/quant/quant_transfusion.py``): the
PTQ driver with ``transfusion_recipe``: the sparse convs, the dense convs
and, through SmoothQuant, the decoder's Linears and Conv1ds; the attention
out-projections and the output convs stay float.

    python -m q3d_tpu_torch.tools.quant_transfusion --cfg_file CFG \
        [driver flags]
"""

from .quant_driver import run

if __name__ == "__main__":
    run("transfusion")
