"""Analytic FLOPs accounting + the card's peak table -> MFU (the JAX
package's ``common/flops.py``, with its chip table replaced by the one
card the port runs on).

Matmul FLOPs are counted analytically per word (2*M*N*K per [M,K]x[K,N]
matmul, backward = 2x forward for the two grad matmuls per layer), and
MFU divides the achieved FLOP rate by the card's published bf16 dense
peak.

Elementwise/gather work (LSTM activations, embedding lookups, sampled-
softmax log-probs) is deliberately excluded: MFU is a matmul-utilization
metric — counting non-tensor-core FLOPs would inflate it.
"""

from __future__ import annotations

from typing import Optional


def lm1b_matmul_flops_per_word(cfg, full_softmax: bool = False) -> int:
    """Fwd+bwd matmul FLOPs per predicted word for the LM1B LSTM LM.

    Per token the forward runs (models/lm1b.py):
      * the fused gate matmul  [1, E+P] x [E+P, 4H]   (2*(E+P)*4H)
      * the projection         [1, H]   x [H, P]      (2*H*P)
      * softmax logits         [1, P]   x [P, S+1]    (sampled: S
        candidates + the true label; full: the whole padded vocab)
    Backward costs 2x forward (each matmul contributes dL/dW and dL/dx).
    """
    E, H, P = cfg.emb_dim, cfg.hidden_dim, cfg.proj_dim
    fwd = 2 * (E + P) * 4 * H + 2 * H * P
    if full_softmax:
        fwd += 2 * P * cfg.padded_vocab
    else:
        fwd += 2 * P * (cfg.num_samples + 1)
    return 3 * fwd


# NVIDIA H100 Tensor Core GPU data sheet: H100 SXM, BF16 Tensor Core
# 1,979 TFLOPS with sparsity, so 989.4 TFLOPS dense. The SXM part names
# itself "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts (lower peaks)
# do not carry "HBM3" in their names.
H100_SXM_PEAK_BF16 = 989.4e12


def peak_flops_per_card(device_kind: str) -> Optional[float]:
    """bf16 dense peak FLOP/s of one card, or None when the card is not
    one whose peak the table knows."""
    k = (device_kind or "").lower()
    if "h100" in k and "hbm3" in k:
        return H100_SXM_PEAK_BF16
    return None


def device_peak_flops(platform: str, device_kind: str) -> Optional[float]:
    """Per-card bf16 peak FLOP/s for the RUNNING backend, or None.

    ``platform`` must be ``"cuda"`` (a CPU yields None, never a
    fabricated number) and ``device_kind`` (``torch.cuda.
    get_device_name``) must name the H100 SXM; every other card also
    yields None (no number beats a wrong one)."""
    if platform != "cuda":
        return None
    return peak_flops_per_card(device_kind)


def mfu(flops_per_word: float, words_per_sec_per_card: float,
        peak: Optional[float]) -> Optional[float]:
    """Model-FLOPs utilization of one card, or None when the peak is
    unknown — an unknown peak must yield no number, never a wrong one."""
    if not peak:
        return None
    return flops_per_word * words_per_sec_per_card / peak
