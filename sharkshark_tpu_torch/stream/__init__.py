"""Host-side stream layer of the live pipeline: ffmpeg decode/encode pipes,
the native frame pump, and the Recoder / Streamer stage services.

Copies of the JAX package's stream/ modules (they import no JAX; the
port keeps its own copies so that it imports nothing of that package).
YouTube ingest (youtube.py) and Twitch chat (chat.py) are not ported yet
(ROADMAP.md).
"""

from .ffmpeg_io import (
    AUDIO_RATE,
    RawFrameSource,
    RawStreamSink,
    decode_audio_cmd,
    decode_video_cmd,
    encode_cmd,
    ffmpeg_binary,
)
from .grabber import QUALITY_RESOLUTION, AudioGrabber, ImageGrabber, resolve_stream_url
from .output import BufferedOutputStream, get_closest_ingest
from .recoder import Recoder, RecoderEntry
from .streamer import Streamer, StreamerEntry

__all__ = [
    "AUDIO_RATE", "RawFrameSource", "RawStreamSink",
    "decode_audio_cmd", "decode_video_cmd", "encode_cmd", "ffmpeg_binary",
    "QUALITY_RESOLUTION", "AudioGrabber", "ImageGrabber", "resolve_stream_url",
    "BufferedOutputStream", "get_closest_ingest",
    "Recoder", "RecoderEntry", "Streamer", "StreamerEntry",
]
