from .adamw import (AdamWConfig, adamw_init, adamw_update, dequantize_state,
                    quantize_state)
from .schedules import cosine_schedule, linear_warmup
