"""Minimal MSVC x64 COFF archive linker-loader.

The reference's AAC dependency (fdk-aac) ships only as a Windows COFF
archive in this environment (dep_codecs/lib/fdk-aac_x64.lib); the reference
build therefore has no AAC on Linux. This module links those objects into
an executable image at runtime — archive parse, section layout, AMD64
relocations, CRT resolution against the ms_abi shims in
native/src/coffrt.cc — so the fdk encoder/decoder can run as the AAC test
oracle and interim decode backend.

Format references: PE/COFF spec (Microsoft, public) — 20-byte file header,
40-byte section headers, 18-byte symbol records, 10-byte relocations;
IMAGE_REL_AMD64_* relocation semantics.
"""

from __future__ import annotations

import ctypes
import struct

from ... import native

_RT = None


def _runtime():
    global _RT
    if _RT is None:
        rt = native.load(native.COFF_RUNTIME)
        rt.iamf_coff_alloc.restype = ctypes.c_void_p
        rt.iamf_coff_alloc.argtypes = [ctypes.c_size_t]
        rt.iamf_coff_shim.restype = ctypes.c_void_p
        rt.iamf_coff_shim.argtypes = [ctypes.c_char_p]
        rt.iamf_coff_call.restype = ctypes.c_uint64
        rt.iamf_coff_call.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
        _RT = rt
    return _RT


def _ar_members(data: bytes):
    assert data[:8] == b"!<arch>\n", "not an ar archive"
    pos = 8
    longnames = None
    out = []
    while pos + 60 <= len(data):
        name = data[pos:pos + 16].decode("latin1").rstrip()
        size = int(data[pos + 48:pos + 58].decode().strip())
        body_off = pos + 60
        if name == "//":
            longnames = data[body_off:body_off + size]
        out.append((name, body_off, size))
        pos = body_off + size + (size & 1)
    resolved = []
    for name, off, size in out:
        if name.startswith("/") and name not in ("/", "//") and longnames:
            idx = int(name[1:])
            end = longnames.index(b"\x00", idx)
            name = longnames[idx:end].decode("latin1")
        resolved.append((name, off, size))
    return resolved


class _Section:
    __slots__ = ("name", "data", "vsize", "relocs", "align", "addr", "keep")

    def __init__(self, name, data, vsize, relocs, align, keep):
        self.name, self.data, self.vsize = name, data, vsize
        self.relocs, self.align, self.keep = relocs, align, keep
        self.addr = None


class _Obj:
    __slots__ = ("name", "sections", "symbols")


_SKIP_PREFIX = (".debug", ".drectve", ".llvm", ".chks64")


def _parse_obj(data: bytes, off: int, size: int, name: str) -> _Obj:
    d = data[off:off + size]
    machine, nsec = struct.unpack_from("<HH", d, 0)
    assert machine == 0x8664, f"{name}: not AMD64 COFF (0x{machine:x})"
    symoff, nsym = struct.unpack_from("<II", d, 8)
    strtab = d[symoff + nsym * 18:]

    def symname(rec):
        nm = rec[:8]
        if nm[:4] == b"\x00\x00\x00\x00":
            so, = struct.unpack("<I", nm[4:8])
            return strtab[so:strtab.index(b"\x00", so)].decode("latin1")
        return nm.rstrip(b"\x00").decode("latin1")

    obj = _Obj()
    obj.name = name
    obj.sections = [None]  # 1-based
    for i in range(nsec):
        sh = d[20 + i * 40: 20 + (i + 1) * 40]
        sname = sh[:8]
        if sname[0:1] == b"/":
            so = int(sname.rstrip(b"\x00")[1:])
            sname = strtab[so:strtab.index(b"\x00", so)]
        else:
            sname = sname.rstrip(b"\x00")
        sname = sname.decode("latin1")
        (vsize, _va, rawsz, rawptr, relptr, _lnptr, nrel, _nln,
         chars) = struct.unpack_from("<IIIIIIHHI", sh, 8)
        align = 1 << (((chars >> 20) & 0xF) - 1) if (chars >> 20) & 0xF else 16
        keep = not (sname.startswith(_SKIP_PREFIX) or chars & 0x200  # LNK_INFO
                    or chars & 0x800)  # LNK_REMOVE
        if chars & 0x80:  # uninitialized (bss)
            body = None
            bsz = max(vsize, rawsz)
        else:
            body = bytearray(d[rawptr:rawptr + rawsz])
            bsz = rawsz
        relocs = []
        if nrel and keep:
            base = relptr
            count = nrel
            if chars & 0x01000000 and nrel == 0xFFFF:  # NRELOC_OVFL
                count = struct.unpack_from("<I", d, base)[0] - 1
                base += 10
            for r in range(count):
                va, symidx, rtype = struct.unpack_from("<IIH", d,
                                                       base + r * 10)
                relocs.append((va, symidx, rtype))
        obj.sections.append(
            _Section(sname, body, bsz, relocs, align, keep))
    # symbols (raw records kept; aux skipped)
    obj.symbols = []
    i = 0
    while i < nsym:
        rec = d[symoff + i * 18: symoff + (i + 1) * 18]
        value, secnum, _t, sclass, naux = struct.unpack_from("<IhHBB", rec, 8)
        obj.symbols.append((symname(rec), value, secnum, sclass))
        for _ in range(naux):
            obj.symbols.append(None)  # keep indices aligned
        i += 1 + naux
    return obj


class CoffImage:
    """A linked, relocated, executable image of a COFF archive."""

    def __init__(self, lib_path: str):
        rt = _runtime()
        data = open(lib_path, "rb").read()
        objs = [
            _parse_obj(data, off, size, name)
            for name, off, size in _ar_members(data)
            if name.endswith(".obj")
        ]

        # layout
        total = 0
        for o in objs:
            for s in o.sections[1:]:
                if not s.keep:
                    continue
                total = (total + s.align - 1) & ~(s.align - 1)
                s.addr = total  # offset for now
                total += s.vsize
        thunk_area = 0x4000
        total = (total + 15) & ~15
        thunk_base = total
        total += thunk_area
        base = rt.iamf_coff_alloc(total)
        if not base:
            raise OSError("coff region alloc failed")
        self.base = base
        self.size = total
        mem = (ctypes.c_char * total).from_address(base)
        for o in objs:
            for s in o.sections[1:]:
                if not s.keep:
                    continue
                s.addr = base + s.addr
                if s.data is not None:
                    mem[s.addr - base: s.addr - base + len(s.data)] = bytes(
                        s.data)
                else:
                    ctypes.memset(s.addr, 0, s.vsize)

        # global symbol table (first definition wins; COMDAT dedup)
        self.symbols: dict[str, int] = {}
        for o in objs:
            for sym in o.symbols:
                if sym is None:
                    continue
                name, value, secnum, sclass = sym
                if sclass == 2 and secnum > 0:
                    sec = o.sections[secnum]
                    if sec.keep and name not in self.symbols:
                        self.symbols[name] = sec.addr + value

        # extern resolution: shims via in-region thunks / data cells
        thunks = {}
        self._thunk_ptr = base + thunk_base

        def extern_addr(name: str) -> int:
            if name in self.symbols:
                return self.symbols[name]
            if name in thunks:
                return thunks[name]
            if name == "__ImageBase":
                thunks[name] = self.base
                return self.base
            shim = rt.iamf_coff_shim(name.encode())
            if shim is None:
                raise KeyError(f"unresolved external: {name}")
            if name in ("__security_cookie", "_fltused", "__isa_available"):
                # data shim: in-region cell initialized from the shim value
                cell = self._alloc_thunk(8)
                init = (ctypes.c_uint64.from_address(shim).value
                        if name == "__security_cookie" else
                        ctypes.c_uint32.from_address(shim).value)
                ctypes.c_uint64.from_address(cell).value = init
                thunks[name] = cell
                return cell
            # code thunk: jmp [rip+0]; .quad shim
            t = self._alloc_thunk(14)
            code = b"\xff\x25\x00\x00\x00\x00" + struct.pack("<Q", shim)
            ctypes.memmove(t, code, 14)
            thunks[name] = t
            return t

        # relocate
        for o in objs:
            for s in o.sections[1:]:
                if not s.keep:
                    continue
                for va, symidx, rtype in s.relocs:
                    if rtype in (0, 10, 11):  # ABSOLUTE/SECTION/SECREL
                        continue
                    sym = o.symbols[symidx]
                    if sym is None:
                        raise ValueError(f"{o.name}: reloc to aux symbol")
                    name, value, secnum, sclass = sym
                    if secnum > 0:
                        sec = o.sections[secnum]
                        if not sec.keep:
                            continue
                        if sclass == 2 and name in self.symbols:
                            S = self.symbols[name]
                        else:
                            S = sec.addr + value
                    elif secnum == 0:
                        S = extern_addr(name)
                    else:
                        continue  # absolute/debug
                    P = s.addr + va
                    if rtype == 1:  # ADDR64
                        A = ctypes.c_uint64.from_address(P).value
                        ctypes.c_uint64.from_address(P).value = (S + A) % (
                            1 << 64)
                    elif rtype == 2:  # ADDR32
                        A = ctypes.c_uint32.from_address(P).value
                        v = (S + A) & 0xFFFFFFFF
                        assert S + A < (1 << 32), "ADDR32 overflow"
                        ctypes.c_uint32.from_address(P).value = v
                    elif rtype == 3:  # ADDR32NB (RVA)
                        A = ctypes.c_uint32.from_address(P).value
                        ctypes.c_uint32.from_address(P).value = (
                            S + A - self.base) & 0xFFFFFFFF
                    elif 4 <= rtype <= 9:  # REL32 .. REL32_5
                        k = rtype - 4
                        A = ctypes.c_int32.from_address(P).value
                        rel = S + A - (P + 4 + k)
                        assert -(1 << 31) <= rel < (1 << 31), "REL32 range"
                        ctypes.c_int32.from_address(P).value = rel
                    else:
                        raise ValueError(f"reloc type {rtype} in {o.name}")

        # C++ static initializers (.CRT$XC*), in section-name order
        inits = []
        for o in objs:
            for s in o.sections[1:]:
                if s.keep and s.name.startswith(".CRT$XC") and s.vsize >= 8:
                    for k in range(0, s.vsize, 8):
                        fp = ctypes.c_uint64.from_address(s.addr + k).value
                        if fp:
                            inits.append((s.name, fp))
        self._rt = rt
        for _, fp in sorted(inits, key=lambda x: x[0]):
            self.call(fp, [])

    def _alloc_thunk(self, n: int) -> int:
        p = (self._thunk_ptr + 15) & ~15
        self._thunk_ptr = p + n
        assert self._thunk_ptr <= self.base + self.size
        return p

    def sym(self, name: str) -> int:
        return self.symbols[name]

    def call(self, fn: int, args) -> int:
        a = (ctypes.c_uint64 * max(len(args), 1))(
            *[int(x) & ((1 << 64) - 1) for x in args] or [0])
        return self._rt.iamf_coff_call(
            ctypes.c_void_p(fn), len(args), a)
