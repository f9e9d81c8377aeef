"""Model zoo of the port: the GPT serving forward so far."""
from .gpt import (GPTConfig, gpt_param_names, gpt_paged_prefill,
                  gpt_paged_step, gpt_paged_suffix_prefill,
                  gpt_serving_params, random_gpt_checkpoint,
                  serving_params_from_numpy)

__all__ = ["GPTConfig", "gpt_param_names", "gpt_serving_params",
           "serving_params_from_numpy", "random_gpt_checkpoint",
           "gpt_paged_prefill", "gpt_paged_step",
           "gpt_paged_suffix_prefill"]
