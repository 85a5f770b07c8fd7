from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion)
from .llama import LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion
from .moe_gpt import MoEGPTBlock, MoEGPTConfig, MoEGPTForCausalLM

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "LlamaConfig", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "MoEGPTBlock", "MoEGPTConfig",
           "MoEGPTForCausalLM"]
