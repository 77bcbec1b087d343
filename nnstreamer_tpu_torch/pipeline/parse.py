"""Pipeline description parser: gst-launch syntax → Pipeline.

A copy of ``nnstreamer_tpu/pipeline/parse.py`` that builds the port's
:class:`~nnstreamer_tpu_torch.pipeline.graph.Pipeline` on a device. The
reference's user interface is gst-launch-1.0 pipeline strings
(SURVEY.md §1 L6; the flex/bison parser in tools/development/parser/).
This parser covers the practically-used grammar:

    chain    := node ( '!' node )*
    node     := element | caps | ref
    element  := NAME (key=value)*          # value may be 'quoted'
    caps     := media/type[,key=value...]  # not ported yet: a ParseError
    ref      := NAME. | NAME.src_N | NAME.sink_N | NAME.N

Branches: a chain starting with ``name.`` continues from that named
element (tee/demux fan-out), a chain ending in ``name.sink_N`` terminates
into it (mux fan-in) — gst-launch semantics:

    videotestsrc num-frames=8 ! tee name=t
        t. ! queue ! tensor_converter ! tensor_sink name=a
        t. ! queue ! tensor_converter ! tensor_sink name=b
"""

from __future__ import annotations

import re
import shlex
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.device import DeviceLike
from nnstreamer_tpu_torch.elements.base import Element
from nnstreamer_tpu_torch.pipeline.graph import Pipeline

_REF_RE = re.compile(r"^([A-Za-z_][\w-]*)\.(?:(src|sink)_(\d+)|(\d+))?$")
_PROP_RE = re.compile(r"^([A-Za-z_][\w-]*)=(.*)$", re.S)
_CAPS_RE = re.compile(r"^[a-z]+/[\w.+-]+(,.*)?$")


class ParseError(ValueError):
    pass


def _tokenize(description: str) -> List[str]:
    lex = shlex.shlex(description, posix=True)
    lex.whitespace_split = True
    lex.commenters = "#"
    return list(lex)


class _Builder:
    def __init__(self, device: DeviceLike) -> None:
        self.pipeline = Pipeline(device=device)
        self.prev: Optional[Element] = None
        self.prev_src_pad: Optional[int] = None
        self.expect_link = False

    def attach(self, elem: Element) -> None:
        self._attach(elem, None)

    def ref_token(self, name: str, pad_kind: Optional[str], pad: Optional[int]) -> None:
        try:
            elem = self.pipeline[name]
        except KeyError as exc:
            raise ParseError(f"reference to unknown element {name!r}") from exc
        if self.expect_link:
            # link target: '... ! mux.sink_0' — chain terminates here
            dst_pad = pad if pad_kind in (None, "sink") else None
            self.pipeline.link(self.prev, elem, src_pad=self.prev_src_pad, dst_pad=dst_pad)
            self.prev = None
            self.prev_src_pad = None
            self.expect_link = False
        else:
            # branch start: 't. ! ...' — continue from named element
            self.prev = elem
            self.prev_src_pad = pad if pad_kind in (None, "src") else None

    def _attach(self, elem: Element, dst_pad: Optional[int]) -> None:
        if self.expect_link:
            if self.prev is None:
                raise ParseError("dangling '!'")
            self.pipeline.link(self.prev, elem, src_pad=self.prev_src_pad, dst_pad=dst_pad)
            self.expect_link = False
        self.prev = elem
        self.prev_src_pad = None

    def bang(self) -> None:
        if self.prev is None:
            raise ParseError("'!' with nothing to link from")
        if self.expect_link:
            raise ParseError("duplicate '!'")
        self.expect_link = True


def _scan(tokens: List[str]):
    """Token stream → item list: ('bang',), ('ref', name, kind, pad),
    ('caps', token), ('element', factory, props)."""
    items = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok == "!":
            items.append(("bang",))
            i += 1
            continue
        ref = _REF_RE.match(tok)
        if ref and "=" not in tok:
            name, kind, pad_s, pad2 = ref.groups()
            pad = int(pad_s) if pad_s is not None else (int(pad2) if pad2 else None)
            items.append(("ref", name, kind, pad))
            i += 1
            continue
        if _CAPS_RE.match(tok) and "=" not in tok.split(",")[0]:
            items.append(("caps", tok))
            i += 1
            continue
        if not re.match(r"^[A-Za-z_][\w-]*$", tok):
            raise ParseError(f"unexpected token {tok!r}")
        props: Dict[str, str] = {}
        j = i + 1
        while j < len(tokens):
            m = _PROP_RE.match(tokens[j])
            if not m or tokens[j] == "!":
                break
            props[m.group(1)] = m.group(2)
            j += 1
        items.append(("element", tok, props))
        i = j
    return items


def scan_description(description: str):
    """Tokenize + scan a launch string into structural items without
    instantiating anything — the shared front end of parse_pipeline and
    the static analyzer. Raises ParseError."""
    tokens = _tokenize(description)
    if not tokens:
        raise ParseError("empty pipeline description")
    return _scan(tokens)


def parse_pipeline(description: str, device: DeviceLike = None) -> Pipeline:
    """Build a Pipeline from a launch string, on ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    items = scan_description(description)
    # pass 1: instantiate all elements so forward references ('! mux.sink_0'
    # before 'tensor_mux name=mux' appears, gst-launch-legal) resolve
    b = _Builder(device)
    instances: List[Optional[Element]] = []
    for item in items:
        if item[0] == "element":
            _, factory, props = item
            cls = registry.get(registry.KIND_ELEMENT, factory)
            props = dict(props)
            elem_name = props.pop("name", None)
            try:
                elem = cls(name=elem_name, **props)
            except TypeError as exc:
                # a bare TypeError from cls(**props) is useless to the
                # user — name the element and the offending property
                m = re.search(r"unexpected keyword argument '([^']+)'",
                              str(exc))
                what = (
                    f"unknown property {m.group(1)!r}" if m
                    else f"bad properties {sorted(props)}"
                )
                raise ParseError(
                    f"element {factory!r}"
                    f"{f' (name={elem_name})' if elem_name else ''}: "
                    f"{what}: {exc}"
                ) from exc
            b.pipeline.add(elem)
            instances.append(elem)
        elif item[0] == "caps":
            raise ParseError(f"caps filters are not ported yet: {item[1]!r}")
        else:
            instances.append(None)
    # pass 2: wire links
    for item, inst in zip(items, instances):
        if item[0] == "bang":
            b.bang()
        elif item[0] == "ref":
            _, name, kind, pad = item
            b.ref_token(name, kind, pad)
        else:
            b.attach(inst)
    if b.expect_link:
        raise ParseError("pipeline ends with '!'")
    return b.pipeline
