"""Host-side stream layer of the live pipeline: ffmpeg decode/encode pipes,
the native frame pump, YouTube ingest, Twitch chat, and the Recoder /
Streamer stage services.

Copies of the JAX package's stream/ modules (they import no JAX; the
port keeps its own copies so that it imports nothing of that package).
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
from .chat import ChatStream
from .recoder import Recoder, RecoderEntry
from .streamer import Streamer, StreamerEntry
from .youtube import ChunkAssembler, YoutubeImageRecoder

__all__ = [
    "AUDIO_RATE", "RawFrameSource", "RawStreamSink",
    "decode_audio_cmd", "decode_video_cmd", "encode_cmd", "ffmpeg_binary",
    "QUALITY_RESOLUTION", "AudioGrabber", "ImageGrabber", "resolve_stream_url",
    "BufferedOutputStream", "get_closest_ingest", "ChatStream",
    "Recoder", "RecoderEntry", "Streamer", "StreamerEntry",
    "ChunkAssembler", "YoutubeImageRecoder",
]
