"""gdm_tpu_torch: the PyTorch + CUDA port of gdm_tpu for NVIDIA Hopper.

The JAX package ``gdm_tpu`` stays the reference; this package is its
counterpart module by module and imports ``torch``, never ``jax`` or
``flax``.  The first slice is single-object inference served over HTTP:

    data/pipeline   finalize_batch (colour, backprojection, normals,
                    point gather), build_pyramid (exact KNN index pyramid)
    models/         GeoMatch at eval: ResNet18/PSPNet + RandLA fused by
                    FFB6D, SplineCNN mesh encoder, heads
    ops/            similarity (CUDA kernel, csrc/similarity.cu), knn,
                    kabsch, backproject, normals, spline_basis
    eval/           pose_fit (seg mask -> similarity argmax -> Kabsch),
                    infer.run_inference
    serve           PoseEngine (the meta/run interface of a serving artifact)
    server          PoseService + HTTP front end, the JAX package's protocol
    configs         the served shapes and widths (LMO preset)
    weights         loads the reference-named state dict that
                    gdm_tpu.train.import_torch.export_state_dict emits
"""
