"""AtacWorks 1D dilated-conv ResNet — the paper's own end-to-end workload
(Lal et al. 2019; Chaudhary et al. 2021 §4.2/§4.4).  Same values as
``repro/configs/atacworks.py``.

25 conv1d layers; most have C=K=15, S=51, dilation=8.  Input: 1D ATAC-seq
coverage track segments of width 50,000 padded to 60,000.  Two heads:
denoised signal + peak calls.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="atacworks",
    family="conv",
    conv_channels=15,
    conv_filter=51,
    conv_dilation=8,
    dtype="float32",
    source="paper §4.2; Lal et al. 2019",
))

# BF16 variant used in the paper's Cooper Lake experiments (C=K=16).
CONFIG_BF16 = register(ModelConfig(
    name="atacworks-bf16",
    family="conv",
    conv_channels=16,
    conv_filter=51,
    conv_dilation=8,
    dtype="bfloat16",
    source="paper §4.4 (BF16, C=K=16)",
))
