from repro_torch.kernels.flash_attention.kernel import (SOURCE,
                                                       flash_attention,
                                                       flash_attention_plain,
                                                       kernel_info)
from repro_torch.kernels.flash_attention.ops import (attention,
                                                     decode_attention)
from repro_torch.kernels.flash_attention.ref import (decode_ref, gqa_ref,
                                                     mha_ref)

__all__ = ["SOURCE", "flash_attention", "flash_attention_plain",
           "kernel_info", "attention", "decode_attention", "mha_ref", "gqa_ref",
           "decode_ref"]
