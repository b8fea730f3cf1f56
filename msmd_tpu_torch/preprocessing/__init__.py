"""Offline video->(expression, head pose, audio) preprocessing pipeline.

The port of ``msmd_tpu/preprocessing`` (the same 13 modules, CLIs and
flags, importing nothing of the JAX package): a host-side rebuild of the
reference's 6-step pipeline
(reference: dataset_processing/Step1..Step6): face detection + bbox
tracking, head-pose estimation, expression-code extraction (user-model
extension point), dataset filtering, resampling/assembly, and split
generation. Heavy dependencies (mediapipe, cv2, lmdb, librosa) are
imported lazily per step; the numeric cores (tracking, procrustes,
smoothing, affine crops, splits) are NumPy, the head pose's quaternion
conversions on the port's rotations (``ops/rotations.py``).
"""
