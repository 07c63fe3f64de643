"""Array operations of the port: kernels with their plain versions, metrics.

``LAUNCH_COUNTERS`` names each hand kernel's launch counter, which its
wrapper adds one to where it launches the kernel; ``launch_counts`` reads
them (the run scheduler's workers record them as gauges, ``chip_smoke.py``
zeroes and reads them around each path).
"""

import sys
from typing import Dict

#: Each hand kernel's launch counter: name -> (wrapper module, attribute).
LAUNCH_COUNTERS = {
    "fused_mnist_forward": ("simple_tip_tpu_torch.ops.fused_forward", "LAUNCHES"),
    "fused_cifar10_forward": ("simple_tip_tpu_torch.ops.fused_forward", "CIFAR_LAUNCHES"),
    "dsa_nearest": ("simple_tip_tpu_torch.ops.dsa_cuda", "LAUNCHES"),
    "flash_attention_fwd": ("simple_tip_tpu_torch.ops.flash_attention", "LAUNCHES"),
    "flash_attention_bwd_dq": ("simple_tip_tpu_torch.ops.flash_attention", "BWD_DQ_LAUNCHES"),
    "flash_attention_bwd_dkv": ("simple_tip_tpu_torch.ops.flash_attention", "BWD_DKV_LAUNCHES"),
    # the bf16 scoring mode's kernels
    "fused_mnist_forward_bf16": ("simple_tip_tpu_torch.ops.fused_forward", "BF16_LAUNCHES"),
    "fused_cifar10_forward_bf16": ("simple_tip_tpu_torch.ops.fused_forward",
                                   "CIFAR_BF16_LAUNCHES"),
    "flash_attention_fwd_bf16": ("simple_tip_tpu_torch.ops.flash_attention", "BF16_LAUNCHES"),
}


def launch_counts() -> Dict[str, int]:
    """Each hand kernel's launches in this process, for the kernels whose
    wrapper module is imported (a process that never imported one
    imports nothing for it)."""
    counts = {}
    for name, (module_name, attr) in LAUNCH_COUNTERS.items():
        module = sys.modules.get(module_name)
        if module is not None:
            counts[name] = int(getattr(module, attr))
    return counts
