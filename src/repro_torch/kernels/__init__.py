"""Hand-written CUDA kernels (``csrc/``, built for ``sm_90a`` by
:mod:`.build`), their wrappers (:mod:`.edm_update`,
:mod:`.paged_attention`, :mod:`.paged_prefill`, over the shared ctypes
helpers of :mod:`._ffi`), their plain PyTorch versions (:mod:`.ref`) and
the device dispatch (:mod:`.ops`).  Importing this package builds
nothing: kernels compile at their first CUDA use."""
