from repro_torch.models.model import (DecodeState, Model, PagedDecodeState,
                                      chunk_step, decode_step, decode_step_paged,
                                      init_params, paged_splice_prompt, prefill)

__all__ = ["DecodeState", "Model", "PagedDecodeState", "chunk_step", "decode_step",
           "decode_step_paged", "init_params", "paged_splice_prompt", "prefill"]
