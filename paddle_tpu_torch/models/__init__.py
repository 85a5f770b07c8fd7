from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion)
from .llama import LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "LlamaConfig", "LlamaForCausalLM",
           "LlamaPretrainingCriterion"]
