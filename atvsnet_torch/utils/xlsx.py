"""Minimal dependency-free XLSX writer, used when xlsxwriter is not installed
(the port's copy of atvsnet_tpu/utils/xlsx.py).

Produces a single-sheet workbook with inline strings/numbers — enough to reproduce the
reference's error.xlsx artifact (written at reference example.py:199-213).
"""

from __future__ import annotations

import zipfile
from typing import Dict, Tuple, Union

Cell = Union[str, float, int]

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(c: int) -> str:
    name = ""
    c += 1
    while c:
        c, rem = divmod(c - 1, 26)
        name = chr(65 + rem) + name
    return name


def _escape(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


class Worksheet:
    def __init__(self):
        self.cells: Dict[Tuple[int, int], Cell] = {}

    def write(self, row: int, col: int, value: Cell) -> None:
        self.cells[(row, col)] = value

    def _xml(self) -> str:
        rows: Dict[int, list] = {}
        for (r, c), v in sorted(self.cells.items()):
            rows.setdefault(r, []).append((c, v))
        body = []
        for r in sorted(rows):
            cells = []
            for c, v in rows[r]:
                ref = f"{_col_name(c)}{r + 1}"
                if isinstance(v, str):
                    cells.append(f'<c r="{ref}" t="inlineStr"><is><t>{_escape(v)}</t></is></c>')
                else:
                    cells.append(f'<c r="{ref}"><v>{v!r}</v></c>')
            body.append(f'<row r="{r + 1}">' + "".join(cells) + "</row>")
        return (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
            "<sheetData>" + "".join(body) + "</sheetData></worksheet>"
        )


class Workbook:
    """xlsxwriter-compatible subset: add_worksheet() -> .write(r, c, v); close()."""

    def __init__(self, path: str):
        self.path = path
        self.sheets = []

    def add_worksheet(self, name: str = "Sheet1") -> Worksheet:
        ws = Worksheet()
        self.sheets.append((name or "Sheet1", ws))
        return ws

    def close(self) -> None:
        name, ws = self.sheets[0] if self.sheets else ("Sheet1", Worksheet())
        # sheet names have a 31-char limit and forbid some chars; keep it simple
        name = _escape(name[:31]) or "Sheet1"
        with zipfile.ZipFile(self.path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("[Content_Types].xml", _CONTENT_TYPES)
            z.writestr("_rels/.rels", _RELS)
            z.writestr("xl/workbook.xml", _WORKBOOK.format(name=name))
            z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
            z.writestr("xl/worksheets/sheet1.xml", ws._xml())
