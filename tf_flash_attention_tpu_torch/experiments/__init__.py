"""The experiment tools of ``tools/`` that carry their own Pallas kernels,
ported: one module per tool, each with its kernels' plain PyTorch versions,
wrappers that launch the CUDA kernel for a tensor on the card (and take the
plain version for a tensor on the CPU), and a ``main()`` that prints the
tool's lines with the card's numbers::

    python -m tf_flash_attention_tpu_torch.experiments.exp_decode
    python -m tf_flash_attention_tpu_torch.experiments.exp_int4_unpack
    python -m tf_flash_attention_tpu_torch.experiments.exp_resident
    python -m tf_flash_attention_tpu_torch.experiments.exp_kv_unroll
    python -m tf_flash_attention_tpu_torch.experiments.exp_vpu_attrib

Each ``main()`` needs a CUDA card and exits non-zero without one.
"""
