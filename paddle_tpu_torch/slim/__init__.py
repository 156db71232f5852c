"""Post-training quantization for serving: int8 weights and calibrated
KV scales as data (the export the int8 serving arm loads)."""
from .serving_export import (GPT_QUANT_WEIGHT_SUFFIXES, calibrate_kv_scales,
                             export_serving_quant, quantize_gpt_weights)

__all__ = ["export_serving_quant", "quantize_gpt_weights",
           "calibrate_kv_scales", "GPT_QUANT_WEIGHT_SUFFIXES"]
