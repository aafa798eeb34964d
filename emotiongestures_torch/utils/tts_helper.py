"""TTS demo helper (port of emotiongestures_tpu/utils/tts_helper.py; the
reference's utils/tts_helper.py:9-104), the same API: the
google-cloud-texttospeech dependency is optional and gated behind an
ImportError. Synthesised wavs are cached by a hash of the voice and the
text, as in the reference's cache directory."""
from __future__ import annotations

import hashlib
import os
from pathlib import Path


class TTSHelper:
    """Cached text-to-speech. Requires `google-cloud-texttospeech` and
    GCP credentials; raises a clear ImportError otherwise."""

    def __init__(self, cache_path: str = "./cache/tts",
                 voice_name: str = "en-US-Wavenet-F",
                 sample_rate: int = 16000):
        self.cache_path = Path(cache_path)
        self.cache_path.mkdir(parents=True, exist_ok=True)
        self.voice_name = voice_name
        self.sample_rate = sample_rate
        try:
            from google.cloud import texttospeech  # noqa: F401

            self._tts = texttospeech
        except ImportError as e:  # pragma: no cover — optional dep
            self._tts = None
            self._import_error = e

    def _cache_file(self, text: str) -> Path:
        key = hashlib.sha1(
            f"{self.voice_name}:{text}".encode()).hexdigest()[:16]
        return self.cache_path / f"{key}.wav"

    def synthesis(self, text: str) -> str:
        """Returns a wav path for `text`, from cache when present."""
        out = self._cache_file(text)
        if out.exists():
            return str(out)
        if self._tts is None:  # pragma: no cover
            raise ImportError(
                "google-cloud-texttospeech is not installed; install the "
                "'tts' extra and set GOOGLE_APPLICATION_CREDENTIALS"
            ) from self._import_error
        tts = self._tts
        client = tts.TextToSpeechClient()
        synthesis_input = tts.types.SynthesisInput(text=text)
        voice = tts.types.VoiceSelectionParams(
            language_code="-".join(self.voice_name.split("-")[:2]),
            name=self.voice_name)
        audio_config = tts.types.AudioConfig(
            audio_encoding=tts.enums.AudioEncoding.LINEAR16,
            sample_rate_hertz=self.sample_rate)
        response = client.synthesize_speech(
            synthesis_input, voice, audio_config)
        with open(out, "wb") as f:
            f.write(response.audio_content)
        return str(out)

    def clean_cache(self):
        for f in self.cache_path.glob("*.wav"):
            os.remove(f)
