from efficientat_tpu_torch.infer.tag import Tagger
from efficientat_tpu_torch.infer.windowed import tag_audio_window

__all__ = ["Tagger", "tag_audio_window"]
