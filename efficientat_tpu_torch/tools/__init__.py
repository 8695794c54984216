"""Tools of the port: the analysis tools of the JAX package's ``tools``
(layer plan, MACs, parameters, peak memory, receptive field, the complexity
report), and the port's own scripts: the probe of the fused log-mel variants
(``probe_mel_kernel``) and the timers of K1 (``time_k1``) and of the
BatchNorm kernels, training and eval mode (``time_bn``)."""

from efficientat_tpu_torch.tools.layer_plan import LayerInfo, layer_plan
from efficientat_tpu_torch.tools.macs import count_macs, count_params
from efficientat_tpu_torch.tools.peak_memory import peak_memory_cnn, peak_memory_mnv3
from efficientat_tpu_torch.tools.receptive_field import receptive_field

__all__ = [
    "LayerInfo",
    "layer_plan",
    "count_macs",
    "count_params",
    "peak_memory_cnn",
    "peak_memory_mnv3",
    "receptive_field",
]
