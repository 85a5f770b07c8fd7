from .bert import (BertConfig, BertForMaskedLM, BertForPretraining,
                   BertForSequenceClassification, BertModel,
                   BertPretrainingCriterion, ErnieModel)
from .gpt import (GPTConfig, GPTForCausalLM, GPTForCausalLMPipe, GPTModel,
                  GPTPretrainingCriterion)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaForCausalLMPipe,
                    LlamaPretrainingCriterion)
from .moe_gpt import MoEGPTBlock, MoEGPTConfig, MoEGPTForCausalLM
from .unet import UNet2DConditionModel, UNetConfig, UNetDenoiseLoss

__all__ = ["BertConfig", "BertForMaskedLM", "BertForPretraining",
           "BertForSequenceClassification", "BertModel",
           "BertPretrainingCriterion", "ErnieModel", "GPTConfig",
           "GPTForCausalLM", "GPTForCausalLMPipe", "GPTModel",
           "GPTPretrainingCriterion",
           "LlamaConfig", "LlamaForCausalLM", "LlamaForCausalLMPipe",
           "LlamaPretrainingCriterion",
           "MoEGPTBlock", "MoEGPTConfig", "MoEGPTForCausalLM",
           "UNet2DConditionModel", "UNetConfig", "UNetDenoiseLoss"]
