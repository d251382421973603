"""MPEG-TS muxer — wraps H.264/AAC frames into transport-stream packets.

Reference: src/brpc/ts.{h,cpp} (TsMuxer/TsChannelGroup, ~1.2 k LoC) —
bRPC uses it to serve HLS out of RTMP streams.  This is a compact
equivalent with the same capability (port of :mod:`brpc_tpu.policy.ts`): PAT/PMT program tables,
PES packetization with PTS/DTS, PCR on the video PID, per-PID continuity
counters, 188-byte fixed packets.  Output is standard ISO 13818-1 TS
playable by any demuxer.
"""
from __future__ import annotations

import struct
from typing import Optional

from ..butil.iobuf import IOBuf

TS_PACKET_SIZE = 188
PID_PAT = 0x0000
PID_PMT = 0x1000
PID_VIDEO = 0x0100
PID_AUDIO = 0x0101

STREAM_TYPE_H264 = 0x1B      # AVC video
STREAM_TYPE_AAC = 0x0F       # AAC ADTS audio

_SID_VIDEO = 0xE0            # PES stream ids
_SID_AUDIO = 0xC0


def crc32_mpeg(data: bytes) -> int:
    """CRC-32/MPEG-2 as used by PSI sections (ts.cpp crc table)."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


class TsMuxer:
    """Feed encoded frames, collect TS packets from .buf (an IOBuf)."""

    def __init__(self, sink: Optional[IOBuf] = None,
                 has_video: bool = True, has_audio: bool = True,
                 psi_interval: int = 40):
        self.buf = sink if sink is not None else IOBuf()
        self.has_video = has_video
        self.has_audio = has_audio
        self._cc = {}                      # pid -> continuity counter
        self._frames_since_psi = None      # force PSI before first frame
        self._psi_interval = psi_interval

    # ---- PSI -----------------------------------------------------------

    def _psi_packet(self, pid: int, section: bytes) -> bytes:
        # pointer_field 0 + section, padded with 0xFF
        payload = b"\x00" + section
        head = struct.pack(">BHB", 0x47,
                           0x4000 | pid,               # PUSI set
                           0x10 | self._bump_cc(pid))  # payload only
        pkt = head + payload
        return pkt + b"\xff" * (TS_PACKET_SIZE - len(pkt))

    def _section(self, table_id: int, table_id_ext: int,
                 body: bytes) -> bytes:
        length = len(body) + 9             # after section_length field
        sec = struct.pack(">BHHBBB", table_id, 0xB000 | length,
                          table_id_ext, 0xC1, 0, 0) + body
        return sec + struct.pack(">I", crc32_mpeg(sec))

    def write_pat_pmt(self) -> None:
        pat_body = struct.pack(">HH", 1, 0xE000 | PID_PMT)
        self.buf.append(self._psi_packet(PID_PAT,
                                         self._section(0x00, 1, pat_body)))
        pcr_pid = PID_VIDEO if self.has_video else PID_AUDIO
        es = b""
        if self.has_video:
            es += struct.pack(">BHH", STREAM_TYPE_H264,
                              0xE000 | PID_VIDEO, 0xF000)
        if self.has_audio:
            es += struct.pack(">BHH", STREAM_TYPE_AAC,
                              0xE000 | PID_AUDIO, 0xF000)
        pmt_body = struct.pack(">HH", 0xE000 | pcr_pid, 0xF000) + es
        self.buf.append(self._psi_packet(PID_PMT,
                                         self._section(0x02, 1, pmt_body)))

    # ---- PES -----------------------------------------------------------

    @staticmethod
    def _pts_field(marker: int, t: int) -> bytes:
        t &= (1 << 33) - 1
        return bytes([
            (marker << 4) | (((t >> 30) & 0x7) << 1) | 1,
            (t >> 22) & 0xFF,
            (((t >> 15) & 0x7F) << 1) | 1,
            (t >> 7) & 0xFF,
            ((t & 0x7F) << 1) | 1,
        ])

    def _pes(self, sid: int, pts: int, dts: Optional[int],
             payload: bytes) -> bytes:
        flags = 0x80 if dts is None else 0xC0
        opt = self._pts_field(2 if dts is None else 3, pts)
        if dts is not None:
            opt += self._pts_field(1, dts)
        hdr_len = len(opt)
        total = 3 + hdr_len + len(payload)
        pes_len = total if total <= 0xFFFF and sid != _SID_VIDEO else 0
        return (b"\x00\x00\x01" + bytes([sid])
                + struct.pack(">H", pes_len)
                + bytes([0x80, flags, hdr_len]) + opt + payload)

    def _bump_cc(self, pid: int) -> int:
        cc = self._cc.get(pid, 0)
        self._cc[pid] = (cc + 1) & 0xF
        return cc

    def _write_pes_packets(self, pid: int, pes: bytes,
                           with_pcr: bool, pcr: int) -> None:
        off = 0
        first = True
        n = len(pes)
        while off < n or first:
            head = struct.pack(">BH", 0x47,
                               (0x4000 if first else 0) | pid)
            remaining = n - off
            adaptation = b""
            if first and with_pcr:
                base = pcr & ((1 << 33) - 1)
                # 33-bit base | 6 reserved bits (all 1) | 9-bit extension=0
                pcr_bytes = ((base << 15) | (0x3F << 9)).to_bytes(6, "big")
                adaptation = bytes([7, 0x10]) + pcr_bytes
            space = TS_PACKET_SIZE - 4 - len(adaptation)
            if remaining < space:
                # stuff via adaptation field to fill the packet
                stuff = space - remaining
                if not adaptation:
                    if stuff == 1:
                        adaptation = bytes([0])
                    else:
                        adaptation = bytes([stuff - 1, 0x00]) \
                            + b"\xff" * (stuff - 2)
                else:
                    adaptation = bytes([adaptation[0] + stuff]) \
                        + adaptation[1:] + b"\xff" * stuff
                space = remaining
            afc = 0x30 if adaptation else 0x10
            pkt = head + bytes([afc | self._bump_cc(pid)]) + adaptation \
                + pes[off:off + space]
            assert len(pkt) == TS_PACKET_SIZE, len(pkt)
            self.buf.append(pkt)
            off += space
            first = False

    # ---- public feed API (ts.h TsMuxer::Encode) ------------------------

    def _maybe_psi(self) -> None:
        if (self._frames_since_psi is None
                or self._frames_since_psi >= self._psi_interval):
            self.write_pat_pmt()
            self._frames_since_psi = 0
        self._frames_since_psi += 1

    def write_video(self, pts_90k: int, annexb: bytes,
                    dts_90k: Optional[int] = None) -> None:
        """H.264 access unit in Annex-B byte-stream form (with start
        codes); an AUD is prepended, matching the reference muxer."""
        self._maybe_psi()
        aud = b"\x00\x00\x00\x01\x09\xf0"
        pes = self._pes(_SID_VIDEO, pts_90k, dts_90k, aud + annexb)
        self._write_pes_packets(PID_VIDEO, pes, True, pts_90k)

    # audio PES_packet_length must be exact (only video may use 0, ISO
    # 13818-1 §2.4.3.7) — split oversized batches into multiple PES
    _MAX_AUDIO_PES_PAYLOAD = 0xFFFF - 8

    def write_audio(self, pts_90k: int, adts: bytes) -> None:
        """AAC frame(s) already wrapped in ADTS headers."""
        self._maybe_psi()
        for off in range(0, len(adts), self._MAX_AUDIO_PES_PAYLOAD):
            part = adts[off:off + self._MAX_AUDIO_PES_PAYLOAD]
            pes = self._pes(_SID_AUDIO, pts_90k, None, part)
            self._write_pes_packets(PID_AUDIO, pes,
                                    not self.has_video, pts_90k)
