"""Minimal HTTP/1.1 primitives shared by the gateway and the backend server.

Mirrors the reference's hand-rolled stdlib-only approach (reference
``gateway.py`` parses request lines/headers from raw asyncio streams —
SURVEY.md §2.1) including its hard limits and their exact status codes:
414 (request line), 431 (header count/size), 400 (Content-Length),
413 (body size, checked before reading the body).
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field

HTTP_REASONS = {
    200: "OK", 204: "No Content", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 414: "URI Too Long", 429: "Too Many Requests",
    431: "Request Header Fields Too Large", 500: "Internal Server Error",
    501: "Not Implemented", 502: "Bad Gateway", 503: "Service Unavailable",
    504: "Gateway Timeout",
}


class HttpLimitError(Exception):
    def __init__(self, status: int, message: str, code: str):
        super().__init__(message)
        self.status = status
        self.message = message
        self.code = code


@dataclass
class Request:
    method: str
    path: str
    version: str
    headers: dict[str, str]         # lower-cased names
    raw_header_lines: list[tuple[str, str]] = field(default_factory=list)
    body: bytes = b""


async def read_request(reader: asyncio.StreamReader, *,
                       max_request_line: int = 8192,
                       max_header_line: int = 8192,
                       max_headers: int = 64,
                       max_body: int = 10 * 1024 * 1024,
                       header_timeout: float = 30.0,
                       read_body: bool = True) -> Request | None:
    """Parse one HTTP/1.1 request.  Raises HttpLimitError on limit violations;
    returns None on clean EOF before any bytes."""
    try:
        line = await asyncio.wait_for(reader.readline(), timeout=header_timeout)
    except asyncio.TimeoutError:
        return None
    if not line:
        return None
    if len(line) > max_request_line:
        raise HttpLimitError(414, f"Request line too long (max {max_request_line} bytes)",
                             "uri_too_long")
    try:
        method, path, version = line.decode("latin-1").strip().split(" ", 2)
    except ValueError:
        raise HttpLimitError(400, "Malformed request line", "bad_request") from None

    headers: dict[str, str] = {}
    raw: list[tuple[str, str]] = []
    while True:
        hline = await asyncio.wait_for(reader.readline(), timeout=header_timeout)
        if len(hline) > max_header_line:
            raise HttpLimitError(431, "Request headers too large or too many headers",
                                 "header_fields_too_large")
        if hline in (b"\r\n", b"\n", b""):
            break
        if len(raw) >= max_headers:
            raise HttpLimitError(431, "Request headers too large or too many headers",
                                 "header_fields_too_large")
        text = hline.decode("latin-1").rstrip("\r\n")
        name, sep, value = text.partition(":")
        if not sep:
            raise HttpLimitError(400, "Malformed header line", "bad_request")
        raw.append((name.strip(), value.strip()))
        headers[name.strip().lower()] = value.strip()

    te = headers.get("transfer-encoding", "").lower().strip()
    if te and te != "identity":
        # bodies are Content-Length-framed only; silently treating a
        # chunked body as empty would desync connection framing (the
        # request-smuggling shape, RFC 7230 §3.3.3)
        raise HttpLimitError(400, "Transfer-Encoding not supported",
                             "bad_request")
    cls = {v.strip() for n, v in raw if n.strip().lower() == "content-length"}
    if len(cls) > 1:
        # conflicting duplicates MUST be rejected (RFC 7230 §3.3.2);
        # last-one-wins would let a smuggler desync proxy and backend
        raise HttpLimitError(400, "Conflicting Content-Length headers",
                             "bad_request")

    body = b""
    cl_raw = headers.get("content-length")
    if cl_raw is not None:
        try:
            cl = int(cl_raw)
        except ValueError:
            raise HttpLimitError(400, "Invalid Content-Length", "bad_request") from None
        if cl < 0:
            raise HttpLimitError(400, "Invalid Content-Length", "bad_request")
        if cl > max_body:
            # checked BEFORE reading the body (reference gateway.py:1161-1171)
            raise HttpLimitError(413, f"Request body too large (max {max_body} bytes)",
                                 "payload_too_large")
        if read_body and cl:
            body = await reader.readexactly(cl)
    return Request(method=method, path=path, version=version,
                   headers=headers, raw_header_lines=raw, body=body)


def error_body(message: str, err_type: str, code) -> bytes:
    """OpenAI-compatible error JSON (reference docs/API_REFERENCE.md §Errors)."""
    err = {"message": message, "type": err_type, "code": code}
    if code == "invalid_api_key":
        err["param"] = "authorization"
        err = {"message": message, "type": err_type,
               "param": "authorization", "code": code}
    return json.dumps({"error": err}).encode()


def response_bytes(status: int, body: bytes = b"",
                   content_type: str = "application/json",
                   extra_headers: dict[str, str] | None = None) -> bytes:
    reason = HTTP_REASONS.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {reason}"]
    if body or status not in (204,):
        lines.append(f"Content-Length: {len(body)}")
    if body:
        lines.append(f"Content-Type: {content_type}")
    lines.append("Connection: close")
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head + body


async def send_response(writer: asyncio.StreamWriter, status: int,
                        body: bytes = b"",
                        content_type: str = "application/json",
                        extra_headers: dict[str, str] | None = None) -> int:
    data = response_bytes(status, body, content_type, extra_headers)
    writer.write(data)
    await writer.drain()
    return len(data)


async def send_error(writer: asyncio.StreamWriter, status: int, message: str,
                     err_type: str, code,
                     extra_headers: dict[str, str] | None = None) -> int:
    return await send_response(writer, status,
                               error_body(message, err_type, code),
                               extra_headers=extra_headers)


def sse_event(payload: dict | str) -> bytes:
    if isinstance(payload, str):
        return f"data: {payload}\n\n".encode()
    return b"data: " + json.dumps(payload, separators=(",", ":")).encode() + b"\n\n"
