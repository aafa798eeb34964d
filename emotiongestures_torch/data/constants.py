"""Dataset constants the serving path needs (copied from
emotiongestures_tpu/data/dataset.py, not imported)."""

EMOTION_LABELS = ["neutral", "happiness", "anger", "sadness", "contempt",
                  "surprise", "fear", "disgust"]
