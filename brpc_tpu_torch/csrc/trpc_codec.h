// The proto3 RpcMeta codec and the TRPC framing of brpc_tpu_torch's native
// core, shared by its two datapaths: the ici:// plane (ici_native.cpp) and
// the TCP server, channel and pool (rpc_native.cpp).  One copy of the wire:
// both produce frames byte-identical to policy/tpu_std.py's.
//
// Included inside ``namespace nrpc`` by each translation unit, after
// <cstdint>, <cstring> and <string>; every function is static (internal to
// the unit that uses it).

#pragma once

// ====================================================================
// proto3 wire codec (varint + length-delimited), RpcMeta subset
// ====================================================================

static void put_varint(std::string& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back((char)((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out.push_back((char)v);
}

static bool get_varint(const uint8_t*& p, const uint8_t* end, uint64_t* v) {
  uint64_t r = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    r |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *v = r;
      return true;
    }
    shift += 7;
  }
  return false;
}

static void put_tag(std::string& out, int field, int wire) {
  put_varint(out, (uint64_t)((field << 3) | wire));
}

static void put_len_field(std::string& out, int field, const std::string& s) {
  if (s.empty()) return;
  put_tag(out, field, 2);
  put_varint(out, s.size());
  out.append(s);
}

static void put_u64_field(std::string& out, int field, uint64_t v) {
  if (v == 0) return;
  put_tag(out, field, 0);
  put_varint(out, v);
}

static bool skip_field(const uint8_t*& p, const uint8_t* end, int wire) {
  uint64_t tmp;
  switch (wire) {
    case 0: return get_varint(p, end, &tmp);
    case 1: if (end - p < 8) return false; p += 8; return true;
    case 2:
      if (!get_varint(p, end, &tmp) || (uint64_t)(end - p) < tmp) return false;
      p += tmp;
      return true;
    case 5: if (end - p < 4) return false; p += 4; return true;
    default: return false;
  }
}

struct MetaRequest {
  std::string service_name, method_name, auth_token;
  uint64_t log_id = 0, trace_id = 0, span_id = 0, parent_span_id = 0;
  uint64_t timeout_ms = 0;
  // admission-control propagation (rpc_meta.proto fields 9-11):
  // priority is offset-encoded on the wire (0 = unset, 1..N = band
  // 0..N-1); deadline_left_ms is the sender's REMAINING budget.
  uint64_t priority = 0;
  std::string tenant;
  uint64_t deadline_left_ms = 0;
  bool present = false;
};

struct MetaResponse {
  uint64_t error_code = 0;
  std::string error_text;
  uint64_t retry_after_ms = 0;   // admission shed backoff hint (field 3)
  bool present = false;
};

struct RpcMeta {
  MetaRequest request;
  MetaResponse response;
  uint64_t compress_type = 0;
  uint64_t correlation_id = 0;
  uint64_t attachment_size = 0;
  bool has_stream_settings = false;  // parsed-but-skipped (native path
                                     // doesn't own streams; Python does)
};

static std::string encode_request_meta(const MetaRequest& r) {
  std::string out;
  put_len_field(out, 1, r.service_name);
  put_len_field(out, 2, r.method_name);
  put_u64_field(out, 3, r.log_id);
  put_u64_field(out, 4, r.trace_id);
  put_u64_field(out, 5, r.span_id);
  put_u64_field(out, 6, r.parent_span_id);
  put_u64_field(out, 7, r.timeout_ms);
  put_len_field(out, 8, r.auth_token);
  put_u64_field(out, 9, r.priority);
  put_len_field(out, 10, r.tenant);
  put_u64_field(out, 11, r.deadline_left_ms);
  return out;
}

static std::string encode_response_meta(const MetaResponse& r) {
  std::string out;
  put_u64_field(out, 1, r.error_code);
  put_len_field(out, 2, r.error_text);
  put_u64_field(out, 3, r.retry_after_ms);
  return out;
}

static std::string encode_meta(const RpcMeta& m) {
  std::string out;
  if (m.request.present) {
    std::string sub = encode_request_meta(m.request);
    put_tag(out, 1, 2);
    put_varint(out, sub.size());
    out.append(sub);
  }
  if (m.response.present) {
    std::string sub = encode_response_meta(m.response);
    put_tag(out, 2, 2);
    put_varint(out, sub.size());
    out.append(sub);
  }
  put_u64_field(out, 3, m.compress_type);
  put_u64_field(out, 4, m.correlation_id);
  put_u64_field(out, 5, m.attachment_size);
  return out;
}

static bool decode_len(const uint8_t*& p, const uint8_t* end,
                       const uint8_t** sub, const uint8_t** sub_end) {
  uint64_t n;
  if (!get_varint(p, end, &n) || (uint64_t)(end - p) < n) return false;
  *sub = p;
  *sub_end = p + n;
  p += n;
  return true;
}

static bool decode_string(const uint8_t*& p, const uint8_t* end,
                          std::string* s) {
  const uint8_t *sub, *sub_end;
  if (!decode_len(p, end, &sub, &sub_end)) return false;
  s->assign((const char*)sub, sub_end - sub);
  return true;
}

static bool decode_request_meta(const uint8_t* p, const uint8_t* end,
                                MetaRequest* r) {
  r->present = true;
  while (p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) return false;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    uint64_t v;
    switch (field) {
      case 1: if (!decode_string(p, end, &r->service_name)) return false; break;
      case 2: if (!decode_string(p, end, &r->method_name)) return false; break;
      case 3: if (!get_varint(p, end, &r->log_id)) return false; break;
      case 4: if (!get_varint(p, end, &r->trace_id)) return false; break;
      case 5: if (!get_varint(p, end, &r->span_id)) return false; break;
      case 6: if (!get_varint(p, end, &r->parent_span_id)) return false; break;
      case 7: if (!get_varint(p, end, &r->timeout_ms)) return false; break;
      case 8: if (!decode_string(p, end, &r->auth_token)) return false; break;
      case 9: if (!get_varint(p, end, &r->priority)) return false; break;
      case 10: if (!decode_string(p, end, &r->tenant)) return false; break;
      case 11:
        if (!get_varint(p, end, &r->deadline_left_ms)) return false;
        break;
      default: if (!skip_field(p, end, wire)) return false; break;
    }
    (void)v;
  }
  return true;
}

static bool decode_response_meta(const uint8_t* p, const uint8_t* end,
                                 MetaResponse* r) {
  r->present = true;
  while (p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) return false;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    switch (field) {
      case 1: if (!get_varint(p, end, &r->error_code)) return false; break;
      case 2: if (!decode_string(p, end, &r->error_text)) return false; break;
      case 3:
        if (!get_varint(p, end, &r->retry_after_ms)) return false;
        break;
      default: if (!skip_field(p, end, wire)) return false; break;
    }
  }
  return true;
}

static bool decode_meta(const uint8_t* p, const uint8_t* end, RpcMeta* m) {
  while (p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) return false;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    const uint8_t *sub, *sub_end;
    switch (field) {
      case 1:
        if (!decode_len(p, end, &sub, &sub_end) ||
            !decode_request_meta(sub, sub_end, &m->request))
          return false;
        break;
      case 2:
        if (!decode_len(p, end, &sub, &sub_end) ||
            !decode_response_meta(sub, sub_end, &m->response))
          return false;
        break;
      case 3: if (!get_varint(p, end, &m->compress_type)) return false; break;
      case 4: if (!get_varint(p, end, &m->correlation_id)) return false; break;
      case 5: if (!get_varint(p, end, &m->attachment_size)) return false; break;
      case 6:
        m->has_stream_settings = true;
        if (!skip_field(p, end, wire)) return false;
        break;
      default: if (!skip_field(p, end, wire)) return false; break;
    }
  }
  return true;
}

// ====================================================================
// TRPC frame: "TRPC" + u32be meta_size + u32be body_size
// ====================================================================

static const char kMagic[4] = {'T', 'R', 'P', 'C'};
static const size_t kHeaderSize = 12;

static void put_u32be(std::string& out, uint32_t v) {
  out.push_back((char)(v >> 24));
  out.push_back((char)(v >> 16));
  out.push_back((char)(v >> 8));
  out.push_back((char)v);
}

// header + meta only; the payload rides separate iovecs (no copy)
static std::string pack_head(const RpcMeta& meta, size_t body_len) {
  std::string meta_bytes = encode_meta(meta);
  std::string out;
  out.reserve(kHeaderSize + meta_bytes.size() + body_len);
  out.append(kMagic, 4);
  put_u32be(out, (uint32_t)meta_bytes.size());
  put_u32be(out, (uint32_t)body_len);
  out.append(meta_bytes);
  return out;
}

static std::string pack_frame(const RpcMeta& meta, const void* body,
                              size_t body_len) {
  std::string out = pack_head(meta, body_len);
  out.append((const char*)body, body_len);
  return out;
}

static uint32_t get_u32be(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}
