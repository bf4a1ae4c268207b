"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version. A wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises."""


def launch_counters() -> dict:
    """Every kernel wrapper that counts its launches, by name. Each adds one
    to its `.launches` where it launches its kernel; a replayed CUDA graph
    moves none of them, so `compile/plan.py` adds a capture's counts once
    for each replay."""
    from . import cnn, deconv, gru, int8_trunk, rssm, symlog, two_hot

    return {
        "layernorm_gru_cell": gru.layernorm_gru_cell,
        "layernorm_gru_cell_residuals": gru.layernorm_gru_cell_residuals,
        "conv_ln_silu": cnn.conv_ln_silu,
        "conv_ln_silu_residuals": cnn.conv_ln_silu_residuals,
        "deconv_ln_silu": deconv.deconv_ln_silu,
        "two_hot_log_prob": two_hot.two_hot_log_prob,
        "fused_rssm_step": rssm.fused_rssm_step,
        "fused_int8_trunk": int8_trunk.fused_int8_trunk,
        "symlog": symlog.symlog,
        "symexp": symlog.symexp,
    }
