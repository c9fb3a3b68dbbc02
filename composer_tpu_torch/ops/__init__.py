"""The hand-written Hopper kernels, each behind a wrapper that runs its
plain PyTorch version on a CPU tensor and launches the kernel on a CUDA
tensor, counting each launch."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process: ``batched`` and
    ``single`` (``decode_generate`` at B > 1 and B = 1), ``spec``,
    ``segment``, ``wide``, ``segment_wide``, and the flash kernels as
    ``flash_<fwd|bwd> <route> <head_dim>``."""
    from composer_tpu_torch.ops import decode_kernel_segmented as seg
    from composer_tpu_torch.ops import decode_kernel_wide as dw
    from composer_tpu_torch.ops import decode_kernel_wide_segmented as dws
    from composer_tpu_torch.ops import flash_attention as fa
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.ops.decode_kernel_spec import spec_decode

    counts = {"batched": decode_generate.launches_batched,
              "single": decode_generate.launches_single, "spec": spec_decode.launches,
              "segment": seg.decode_segment.launches, "wide": dw.decode_wide.launches,
              "segment_wide": dws.decode_segment_wide.launches}
    for direction, wrapper in (("fwd", fa.flash_attention_forward),
                               ("bwd", fa.flash_attention_backward)):
        for (route, depth), count in wrapper.launches.items():
            counts[f"flash_{direction} {route} {depth}"] = count
    return counts


def reset_launch_counts() -> None:
    """Sets every count of ``launch_counts`` to 0."""
    from composer_tpu_torch.ops import decode_kernel_segmented as seg
    from composer_tpu_torch.ops import decode_kernel_wide as dw
    from composer_tpu_torch.ops import decode_kernel_wide_segmented as dws
    from composer_tpu_torch.ops import flash_attention as fa
    from composer_tpu_torch.ops.decode_kernel_batched import decode_generate
    from composer_tpu_torch.ops.decode_kernel_spec import spec_decode

    decode_generate.launches_batched = decode_generate.launches_single = 0
    spec_decode.launches = seg.decode_segment.launches = dw.decode_wide.launches = 0
    dws.decode_segment_wide.launches = 0
    for wrapper in (fa.flash_attention_forward, fa.flash_attention_backward):
        wrapper.launches = dict.fromkeys(wrapper.launches, 0)
