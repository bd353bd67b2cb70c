from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_with_lse)
from .ops import attention
from .ref import attention_bwd_ref, attention_delta_ref, attention_ref

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_with_lse", "attention",
           "attention_ref", "attention_bwd_ref", "attention_delta_ref"]
