"""The port's counterparts of the repository's `tools/` kernel experiments
(queue B rows 17-21), on hand-written CUDA kernels:

- `bench_attn_softmax`: five softmax forms inside the attention sub-layer
  (`csrc/attn_variants.cu`);
- `bench_attn_split_cls`: the split-CLS attention layout against the
  shipped one (`csrc/attn_variants.cu`);
- `bench_attn_i8`: int8 scores and int8 context in the W8A8 attention
  sub-layer (`csrc/attn_i8.cu`);
- `debug_attn_i8`: those kernels at depth 1 against a plain mirror, and the
  bf16 sub-layer timed beside variant A;
- `bench_block_fusion`: one ViT block as 3 launches (`csrc/block_tail.cu`)
  against the shipped 5.

And one measurement of the shipped path with no JAX tool behind it:
`loss_drift` (the frozen giant2 loss on the kernels against the plain
path, batch by batch; run as a file, `--root` reads another checkout).
`warm_decode_cache` fills the decoded-volume disk cache of a dataset
folder before training (host only, no card needed).

Each module keeps the plain PyTorch version of its kernel functions (the
CPU path, and what the card's results are held to) and a `main()` that runs
the experiment on the card: `python -m mst_tpu_torch.tools.<name>`. The
mains raise without a CUDA device.
"""
