"""The port's accuracy proofs, weight bridges and benchmark tools, named
after their counterparts in the repo's root `tools/` (which the port never
imports). Each runs on the CUDA card unless `--device cpu` is given; the
proofs are thin layers over the port's CLIs:

- `synth_voc`: the synthetic VOC-format shape scenes (byte-equal to the
  root generator's for the same arguments);
- `torch_to_npz`, `export_torch`: a reference `.pth` <-> weights.msgpack;
- `overfit_proof`, `generalization_proof`, `pretrained_trunk_proof`,
  `int8_budget`: training to an AP number and the int8 paths' cost on
  trained weights, each writing `proofs_torch/<name>.json` (`common`);
- `bench_layers`: the train-mode forward's time per layer (CUDA-graph and
  eager columns, each layer's bound, `--profile`'s kernels by layer);
- `bench_loader`: the records loader plus the copy to the card, in img/s.

    python -m object_detection_torch2_tpu_torch.tools.<module> [--device cpu] ...
"""
