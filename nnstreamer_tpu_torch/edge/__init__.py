"""Among-device streaming: the nnstreamer-edge slot.

Port of ``nnstreamer_tpu/edge/`` (≙ the external nnstreamer-edge
library that backs tensor_query_* and edgesrc/edgesink in the reference,
SURVEY.md §2.4): the length-prefixed TCP protocol (``protocol.py``), the
negotiated wire v2 codecs and coalescing (``wire.py``), the session
layer (``session.py``), the discovery broker (``broker.py``), the KV
handoff between disaggregated LLM replicas (``kv.py``), the MQTT 3.1.1
codec and the in-process broker (``mqtt_wire.py``, ``mqtt.py``) and the
SNTP client (``ntp.py``). The port speaks the JAX package's wire byte
for byte. Everything here runs on the host; no network thread touches
the card.
"""
from .broker import DiscoveryBroker, discover, discover_meta
from .kv import KvReceiver, KvSender
from .mqtt import MqttBroker
from .protocol import MsgKind, recv_msg, send_msg
from .session import (Heartbeat, ReplayRing, SessionConfig, SessionReceiver,
                      new_session_id)
from .wire import WireConfig, accept, advertise, negotiate, tune_socket

__all__ = ["MsgKind", "send_msg", "recv_msg", "DiscoveryBroker", "discover",
           "discover_meta", "KvSender", "KvReceiver", "MqttBroker",
           "WireConfig", "advertise", "negotiate", "accept",
           "tune_socket", "SessionConfig", "SessionReceiver", "ReplayRing",
           "Heartbeat", "new_session_id"]
