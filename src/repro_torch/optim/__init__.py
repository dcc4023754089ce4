from repro_torch.optim.compression import (compress_topk, decompress_topk,
                                           dequantize_int8, quantize_int8)
from repro_torch.optim.optimizers import (ADAFACTOR_PARAM_THRESHOLD,
                                          Optimizer, adafactor, adamw,
                                          clip_by_global_norm,
                                          pick_optimizer, sgd)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["ADAFACTOR_PARAM_THRESHOLD", "Optimizer", "adafactor", "adamw",
           "clip_by_global_norm", "compress_topk", "cosine_schedule",
           "decompress_topk", "dequantize_int8", "linear_warmup",
           "pick_optimizer", "quantize_int8", "sgd"]
