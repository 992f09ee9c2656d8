"""The port's YouTube ingest and Twitch chat (sharkshark_tpu_torch.stream
youtube.py and chat.py) against the JAX package's: ChunkAssembler on the
same shuffled chunks, YoutubeImageRecoder on the same fake download and
decoder, the chat protocol's parsing and keepalive, and a YouTube URL
through the port's Recoder.  `requests` and `av` are replaced by fakes
in sys.modules (PyAV is not installed, and nothing may reach the
network): the fake server returns byte ranges of a blob of fixed-size
records, and the fake decoder turns each record into one frame whose
pixels hold the record's index."""

import random
import sys
import threading
import time
import types

import numpy as np
import pytest
from PIL import Image

from sharkshark_tpu.stream import chat as jchat
from sharkshark_tpu.stream import youtube as jyoutube
from sharkshark_tpu_torch.runtime import EOF
from sharkshark_tpu_torch.stream import ChatStream, ChunkAssembler, Recoder, YoutubeImageRecoder
from sharkshark_tpu_torch.stream import youtube

REC = 256  # bytes a record: one chunk, one packet, one frame
FRAME_HW = (12, 20)
SOURCE_FPS = 24


def _blob(n_frames: int) -> bytes:
    return b"".join(bytes([70, i]) + bytes(REC - 2) for i in range(n_frames))


class _Resp:
    def __init__(self, content):
        self.status_code, self.content = 200, content


def _fake_requests(blob: bytes, seed: int):
    """requests.get over `blob`: '...&range=a-b' returns bytes a..b, after
    a random short delay so that the chunks arrive out of order."""
    rng = random.Random(seed)
    lock = threading.Lock()

    def get(url, timeout=None):
        start, end = map(int, url.rsplit("&range=", 1)[1].split("-"))
        with lock:
            delay = rng.random() * 0.01
        time.sleep(delay)
        return _Resp(blob[start : end + 1])

    return types.SimpleNamespace(get=get)


class _Frame:
    def __init__(self, index):
        self.index = index

    def to_image(self):
        return Image.fromarray(np.full(FRAME_HW + (3,), self.index, np.uint8))


class _Packet:
    def __init__(self, rec):
        self.size, self.rec = len(rec), rec

    def decode(self):
        assert self.rec[0] == 70, "the decoder was given bytes that are not a record"
        return [_Frame(self.rec[1])]


class _Container:
    def __init__(self, stream):
        self.stream = stream
        self.streams = types.SimpleNamespace(video=[types.SimpleNamespace(rate=SOURCE_FPS)])

    def demux(self):
        while True:
            rec = self.stream.read(REC)
            if len(rec) < REC:
                return
            yield _Packet(rec)


def _fake_av():
    return types.SimpleNamespace(open=lambda stream, mode="r": _Container(stream))


@pytest.fixture
def fakes(monkeypatch):
    """Install fake requests and av over a blob of 40 records."""
    n = 40
    blob = _blob(n)
    monkeypatch.setitem(sys.modules, "requests", _fake_requests(blob, seed=3))
    monkeypatch.setitem(sys.modules, "av", _fake_av())
    return n, blob


def _drain(rec, timeout=30.0):
    frames, deadline = [], time.monotonic() + timeout
    while time.monotonic() < deadline:
        f = rec.grab()
        if f is None:
            return frames
        frames.append(f)
    raise AssertionError("the recoder did not reach its end")


# ---------------------------------------------------------------- ChunkAssembler


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_assembler_matches_jax(seed):
    rng = np.random.default_rng(seed)
    size = int(rng.integers(1, 50))
    n = int(rng.integers(5, 40))
    chunks = [(i * size, rng.integers(0, 256, size, dtype=np.uint8).tobytes()) for i in range(n)]
    order = rng.permutation(n)
    got, want = ChunkAssembler(size), jyoutube.ChunkAssembler(size)
    out = []
    for k in order:
        pos, data = chunks[k]
        ready = got.add(pos, data)
        assert ready == want.add(pos, data)
        assert got.next_position == want.next_position
        out += ready
    assert b"".join(out) == b"".join(c for _, c in chunks)
    assert got.pending == {} and got.next_position == n * size


def test_chunk_assembler_reorders():
    a = ChunkAssembler(chunk_size=10)
    assert a.add(10, b"b" * 10) == []
    assert a.add(20, b"c" * 10) == []
    assert a.add(0, b"a" * 10) == [b"a" * 10, b"b" * 10, b"c" * 10]
    assert a.next_position == 30


# ------------------------------------------------------------ YoutubeImageRecoder


@pytest.mark.parametrize("rate", [24, 12])
def test_youtube_recoder_matches_jax(fakes, rate):
    """The same fake download and decoder through both recoders, with
    three workers fetching out of order: the same frames, in order,
    down-sampled by index rounding to `rate`."""
    n, blob = fakes
    kw = dict(url="unused", quality="720p", rate=rate, chunk_size=REC, n_workers=3,
              stream_url="https://video.invalid/videoplayback?id=1", content_size=len(blob))
    outs = []
    for cls in (YoutubeImageRecoder, jyoutube.YoutubeImageRecoder):
        rec = cls(**kw)
        try:
            outs.append(_drain(rec))
        finally:
            rec.terminate()
        rec.join()
    got, want = outs
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == FRAME_HW + (3,) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    # frame i is kept where round(i / fps * rate) moves on
    kept = [i for i in range(1, n) if round(i / SOURCE_FPS * rate) != round((i - 1) / SOURCE_FPS * rate)]
    assert [int(f[0, 0, 0]) for f in got] == kept


class _FakeAudio:
    def grab(self):
        return np.zeros((44100, 2), np.float32)

    def terminate(self):
        pass


def test_youtube_url_builds_the_youtube_recoder(fakes, monkeypatch):
    """A YouTube URL in the port's Recoder ingests through
    YoutubeImageRecoder, as the JAX Recoder does (the stream URL and its
    clen from the resolver)."""
    n, blob = fakes
    monkeypatch.setattr(youtube, "resolve_stream_url",
                        lambda url, quality: f"https://video.invalid/videoplayback?id=1&clen={len(blob)}")
    built = []

    class SmallChunks(YoutubeImageRecoder):
        """The recoder the Recoder builds, with records as chunks."""

        def __init__(self, url, quality, rate):
            built.append((url, quality, rate))
            super().__init__(url, quality, rate, chunk_size=REC, n_workers=3)

    monkeypatch.setattr(youtube, "YoutubeImageRecoder", SmallChunks)
    got = []
    rec = Recoder(url="https://www.youtube.com/watch?v=x", batch_sec=1, fps=12, quality="720p",
                  audio_grabber=_FakeAudio(), overlay=False, on_queue=got.append)
    rec.start()
    assert rec.wait_eof(timeout=30)
    rec.join(timeout=10)
    assert not rec.is_alive and rec._error is None, rec._error
    assert isinstance(rec._image_grabber, YoutubeImageRecoder)
    assert built == [("https://www.youtube.com/watch?v=x", "720p", 12)]
    assert rec._image_grabber.stream_url.endswith(f"clen={len(blob)}")
    assert isinstance(got[-1], EOF)
    frames = np.concatenate([e.frames for e in got[:-1]])
    kept = [i for i in range(1, n) if round(i / 2) != round((i - 1) / 2)]
    assert [int(f[0, 0, 0]) for f in frames] == kept
    assert all(e.frames.shape[1:] == FRAME_HW + (3,) for e in got[:-1])
    rec._image_grabber.terminate()


# ---------------------------------------------------------------------- chat


LINES = [
    "asdf",
    ":tmi.twitch.tv NOTICE * :Login unsuccessful",
    ":tmi.twitch.tv NOTICE * :Error logging in",
    ":tmi.twitch.tv NOTICE * :Login authentication failed",
    ":tmi.twitch.tv NOTICE * :Improperly formatted auth",
    ":alice!alice@alice.tmi.twitch.tv PRIVMSG #bob :hello world",
    ":carol_1!carol_1@carol_1.tmi.twitch.tv PRIVMSG #bob :a :colon inside",
    ":bob!bob@bob.tmi.twitch.tv JOIN #bob",
    "PING :tmi.twitch.tv",
]


def test_chat_protocol_parsing():
    assert ChatStream.logged_in_successful("asdf")
    assert not ChatStream.logged_in_successful(":tmi.twitch.tv NOTICE * :Login unsuccessful")
    assert not ChatStream.logged_in_successful(":tmi.twitch.tv NOTICE * :Error logging in")
    assert not ChatStream.logged_in_successful(":tmi.twitch.tv NOTICE * :Login authentication failed")
    msg = ChatStream.parse_message(":alice!alice@alice.tmi.twitch.tv PRIVMSG #bob :hello world")
    assert msg == {"channel": "#bob", "username": "alice", "message": "hello world"}
    assert ChatStream.parse_message("PING :tmi.twitch.tv") is None
    for line in LINES:
        assert ChatStream.parse_message(line) == jchat.ChatStream.parse_message(line), line
        assert ChatStream.logged_in_successful(line) == jchat.ChatStream.logged_in_successful(line), line


class FakeSock:
    def __init__(self, incoming=()):
        self.sent, self.incoming = [], list(incoming)

    def send(self, data):
        self.sent.append(data)

    def recv(self, n):
        if not self.incoming:
            raise BlockingIOError
        return self.incoming.pop(0)


def test_chat_ping_pong_and_join():
    c = ChatStream("bob", "oauth:x", sock=FakeSock())
    c._handle_line("PING :tmi.twitch.tv")
    # keepalive bypasses the 5 s flood-control buffer
    assert c.sock.sent == [b"PONG :tmi.twitch.tv\r\n"]
    assert c.buffer == []
    c._handle_line(":bob!bob@bob.tmi.twitch.tv JOIN #bob")
    assert c.current_channel == "bob"


def test_chat_receive_and_rate_limited_send():
    """receive_messages drains the socket into parsed messages (answering
    the PING on the way) and sends at most one buffered message each
    SEND_INTERVAL, as the JAX client does."""
    data = ("\r\n".join(LINES[5:]) + "\r\n").encode()
    outs = []
    for cls in (ChatStream, jchat.ChatStream):
        c = cls("bob", "oauth:x", sock=FakeSock([data]))
        c.send_chat_message("one")
        c.send_chat_message("two")
        c.last_sent_time = time.time() - 10  # the interval has passed once
        outs.append((c.receive_messages(), c.sock.sent, c.buffer, c.current_channel))
    assert outs[0] == outs[1]
    msgs, sent, buffer, channel = outs[0]
    assert [m["username"] for m in msgs] == ["alice", "carol_1"]
    assert sent == [b"PRIVMSG #bob :one\n", b"PONG :tmi.twitch.tv\r\n"]
    assert buffer == ["PRIVMSG #bob :two\n"] and channel == "bob"
