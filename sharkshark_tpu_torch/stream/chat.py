"""Twitch IRC chat client.

A copy of the JAX package's stream/chat.py, which imports no JAX.

Capability parity with reference src/stream/twitch_stream/chat.py:18-271:
PASS/NICK login with response validation, channel JOIN tracking, PING->
PONG keepalive, PRIVMSG parsing into {channel, username, message} dicts,
and a >=5-second send rate-limit buffer (Twitch flood control).

The socket is injectable (`sock=`) so the protocol logic is testable
against a scripted fake; `connect()` builds the real non-blocking TCP
socket to irc.twitch.tv:6667.
"""

from __future__ import annotations

import errno
import re
import socket
import time

from ..utils import get_logger

__all__ = ["ChatStream"]

log = get_logger("stream.chat")

IRC_HOST = "irc.twitch.tv"
IRC_PORT = 6667
SEND_INTERVAL = 5.0  # reference chat.py:165

# the reference's pattern (chat.py:63) quantifies the failure text with
# `*`, which also matches the bare NOTICE prefix but NOT Twitch's actual
# modern reply ("Login authentication failed") — extended here so real
# auth failures raise instead of busy-looping in connect()
_LOGIN_FAIL = re.compile(
    r"^:(testserver\.local|tmi\.twitch\.tv)"
    r" NOTICE \* :"
    r"(Login unsuccessful|Error logging in|Login authentication failed"
    r"|Improperly formatted auth)"
)
_PING = re.compile(r"^PING :tmi\.twitch\.tv$")
_JOIN = re.compile(
    r"^:[a-zA-Z0-9_]+\![a-zA-Z0-9_]+@[a-zA-Z0-9_]+"
    r"\.tmi\.twitch\.tv JOIN #([a-zA-Z0-9_]+)$"
)
_PRIVMSG = re.compile(
    r"^:(?P<username>[a-zA-Z0-9_]+)\![a-zA-Z0-9_]+@[a-zA-Z0-9_]+"
    r"\.tmi\.twitch\.tv PRIVMSG (?P<channel>#[a-zA-Z0-9_]+) :(?P<message>.+)$"
)


class ChatStream:
    def __init__(self, username: str, oauth: str, sock: socket.socket | None = None):
        self.username = username
        self.oauth = oauth
        self.current_channel = ""
        self.last_sent_time = time.time()
        self.buffer: list[str] = []
        self.sock = sock

    # -- protocol predicates (pure; reference chat.py:51-107) ------------

    @staticmethod
    def logged_in_successful(data: str) -> bool:
        return not _LOGIN_FAIL.match(data.strip())

    @staticmethod
    def parse_message(line: str) -> dict | None:
        m = _PRIVMSG.match(line)
        if not m:
            return None
        return {
            "channel": m.group("channel"),
            "username": m.group("username"),
            "message": m.group("message"),
        }

    # -- connection -------------------------------------------------------

    def connect(self) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.connect((IRC_HOST, IRC_PORT))
        s.send(f"PASS {self.oauth}\r\n".encode())
        s.send(f"NICK {self.username}\r\n".encode())
        received = s.recv(1024).decode()
        if not self.logged_in_successful(received):
            raise IOError("Twitch did not accept the username-oauth combination")
        s.setblocking(False)
        if self.sock is not None:
            self.sock.close()
        self.sock = s
        self.join_channel(self.username)
        deadline = time.time() + 30
        while self.current_channel != self.username:
            if time.time() > deadline:
                raise IOError("IRC JOIN not acknowledged within 30 s")
            if not self.receive_messages():
                time.sleep(0.05)

    def __enter__(self):
        if self.sock is None:
            self.connect()
        return self

    def __exit__(self, *exc):
        if self.sock is not None:
            self.sock.close()

    # -- sending -----------------------------------------------------------

    def join_channel(self, channel: str) -> None:
        self.sock.send(f"JOIN #{channel}\r\n".encode())

    def send_chat_message(self, message: str) -> None:
        """Buffered send; flushed by receive_messages at most once per
        SEND_INTERVAL (flood control)."""
        self.buffer.append(f"PRIVMSG #{self.username} :{message}\n")

    def _push_from_buffer(self) -> None:
        if self.buffer and time.time() - self.last_sent_time > SEND_INTERVAL:
            try:
                self.sock.send(self.buffer.pop(0).encode())
            finally:
                self.last_sent_time = time.time()

    # -- receiving ----------------------------------------------------------

    def _handle_line(self, line: str) -> dict | None:
        if _PING.match(line):
            # keepalive is NOT subject to flood control: behind the 5 s
            # rate limiter a queued PONG would miss Twitch's ~10 s window
            # and drop the connection
            try:
                self.sock.send(b"PONG :tmi.twitch.tv\r\n")
            except OSError:
                self.buffer.insert(0, "PONG\n")
        joined = _JOIN.match(line)
        if joined:
            self.current_channel = joined.group(1)
        return self.parse_message(line)

    def receive_messages(self) -> list[dict]:
        """Drain the socket; returns parsed chat messages. Call at least
        every ~10 s or Twitch drops unresponsive clients."""
        self._push_from_buffer()
        result: list[dict] = []
        while True:
            try:
                msg = self.sock.recv(4096).decode()
            except (BlockingIOError, InterruptedError):
                return result
            except socket.error as e:
                if e.args and e.args[0] in (errno.EAGAIN, errno.EWOULDBLOCK):
                    return result
                log.warning("chat socket error, reconnecting: %s", e)
                self.connect()
                return result
            if not msg:
                return result
            for line in filter(None, msg.split("\r\n")):
                parsed = self._handle_line(line)
                if parsed:
                    result.append(parsed)
