"""The long-term feature bank store, shared with the JAX package:
``surgical_tpu/data/feature_store.py`` imports only numpy and the standard
library, so the port uses it as it is."""

from surgical_tpu.data.feature_store import FeatureStore, bucket_length, pad_video  # noqa: F401
