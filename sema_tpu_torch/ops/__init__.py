"""Device kernels of the port: the top-k scans (K1, K3, K4a, K4b; K8, the
warm-start scan, and K9, the fold-merge scan, of the scan A/B tools), the
encoder layer, with float (K2) or W8A8 (K5) linears, and the attention of
one shard of heads on the tensor-parallel encoder (K6 with its qkv
projection, K7 without), each a hand-written Hopper kernel beside its
plain PyTorch version."""

from sema_tpu_torch.ops.attention import (attention_block_reference,
                                          attention_qkv_reference,
                                          fused_attention_block,
                                          fused_attention_qkv)
from sema_tpu_torch.ops.encoder_layer import (encoder_layer_reference,
                                              fused_encoder_layer)
from sema_tpu_torch.ops.encoder_layer_int8 import (
    encoder_layer_int8_reference, fused_encoder_layer_int8, qmm,
    qmm_reference)
from sema_tpu_torch.ops.scan_topk import (fold_topk, fold_topk_reference,
                                          scan_topk, scan_topk_int8,
                                          scan_topk_int8_pruned,
                                          scan_topk_pruned,
                                          scan_topk_reference,
                                          scan_topk_warm,
                                          scan_topk_warm_reference)

__all__ = ["scan_topk", "scan_topk_reference", "scan_topk_int8",
           "scan_topk_pruned", "scan_topk_int8_pruned", "scan_topk_warm",
           "scan_topk_warm_reference", "fold_topk", "fold_topk_reference",
           "fused_encoder_layer", "encoder_layer_reference",
           "fused_encoder_layer_int8", "encoder_layer_int8_reference", "qmm",
           "qmm_reference", "fused_attention_qkv", "attention_qkv_reference",
           "fused_attention_block", "attention_block_reference"]
