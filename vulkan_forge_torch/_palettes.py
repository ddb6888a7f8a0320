"""Embedded 256x1 RGBA8 colormap palettes (sRGB-encoded bytes).
Data provenance: viridis/magma are 256 even samples of the matplotlib
colormaps, ``(cmap(linspace(0,1,256))*255).astype(uint8)``; terrain is a
7-stop custom ramp (blue->green->brown->white) linearly interpolated to 256
entries. Regenerate with ``data/generate_palettes.py``. Matches the
reference's embedded assets (src/colormap/assets/*_256x1.png,
src/colormap/mod.rs:10-17) byte-for-byte for +/-1 LSB golden parity.
"""

import base64 as _b64
import numpy as _np

_VIRIDIS_B64 = (
    "RAFU/0QCVf9EA1f/RQVY/0UGWv9FCFv/Rglc/0YLXv9GDF//Rg5h/0cPYv9HEWP/RxJl/0cUZv9HFWf/RxZp/0cY"
    "av9IGWv/SBps/0gcbv9IHW//SB5w/0ggcf9IIXL/SCJz/0gjdP9HJXX/RyZ2/0cnd/9HKHj/Ryp5/0crev9HLHv/"
    "Ri18/0YvfP9GMH3/RjF+/0Uyf/9FNH//RTWA/0U2gf9EN4H/RDmC/0M6g/9DO4P/QzyE/0I9hP9CPoX/QkCF/0FB"
    "hv9BQob/QEOH/0BEh/8/RYf/P0eI/z5IiP8+SYn/PUqJ/z1Lif89TIn/PE2K/zxOiv87UIr/O1GK/zpSi/86U4v/"
    "OVSL/zlVi/84Vov/OFeM/zdYjP83WYz/NlqM/zZbjP81XIz/NV2M/zRejf80X43/M2CN/zNhjf8yYo3/MmON/zFk"
    "jf8xZY3/MWaN/zBnjf8waI3/L2mN/y9qjf8ua47/LmyO/y5tjv8tbo7/LW+O/yxwjv8scY7/LHKO/ytzjv8rdI7/"
    "KnWO/yp2jv8qd47/KXiO/yl5jv8oeo7/KHqO/yh7jv8nfI7/J32O/yd+jv8mf47/JoCO/yaBjv8lgo7/JYON/ySE"
    "jf8khY3/JIaN/yOHjf8jiI3/I4mN/yKJjf8iio3/IouN/yGMjf8hjYz/IY6M/yCPjP8gkIz/IJGM/x+SjP8fk4v/"
    "H5SL/x+Vi/8flov/HpeK/x6Yiv8emYr/HpmK/x6aif8em4n/HpyJ/x6diP8enoj/Hp+I/x6gh/8foYf/H6KG/x+j"
    "hv8gpIX/IKWF/yGmhf8hp4T/IqeE/yOog/8jqYL/JKqC/yWrgf8mrIH/J62A/yiuf/8pr3//KrB+/yuxff8ssX3/"
    "LrJ8/y+ze/8wtHr/MrV6/zO2ef81t3j/Nrh3/zi5dv85uXb/O7p1/z27dP8+vHP/QL1y/0K+cf9EvnD/Rb9v/0fA"
    "bv9JwW3/S8Js/03Ca/9Pw2n/UcRo/1PFZ/9Vxmb/V8Zl/1nHZP9byGL/Xslh/2DJYP9iyl//ZMtd/2fMXP9pzFv/"
    "a81Z/23OWP9wzlb/cs9V/3TQVP930FL/edFR/3zST/9+0k7/gdNM/4PTS/+G1En/iNVH/4vVRv+N1kT/kNZD/5LX"
    "Qf+V1z//l9g+/5rYPP+d2Tr/n9k4/6LaN/+l2jX/p9sz/6rbMv+t3DD/r9wu/7LdLP+13Sv/t90p/7reJ/+93ib/"
    "v98k/8LfIv/F3yH/x+Af/8rgHv/N4B3/z+Ec/9LhG//U4Rr/1+IZ/9riGP/c4hj/3+MY/+HjGP/k4xj/5+QZ/+nk"
    "Gf/s5Br/7uUb//HlHP/z5R7/9uYf//jmIf/65iL//eck/w=="
)

_MAGMA_B64 = (
    "AAAD/wAABP8AAAb/AQAH/wEBCf8BAQv/AgIN/wICD/8DAxH/BAMT/wQEFf8FBBf/BgUZ/wcFG/8IBh3/CQcf/woH"
    "Iv8LCCT/DAkm/w0KKP8OCir/Dwss/xAML/8RDDH/Eg0z/xQNNf8VDjj/Fg46/xcPPP8YDz//GhBB/xsQRP8cEEb/"
    "HhBJ/x8RS/8gEU3/IhFQ/yMRUv8lEVX/JhFX/ygRWf8qEVz/KxFe/y0QYP8vEGL/MBBl/zIQZ/80EGj/NQ9q/zcP"
    "bP85D27/Ow9v/zwPcf8+D3L/QA9z/0IPdP9DD3X/RQ92/0cPd/9IEHj/ShB5/0sQef9NEXr/TxF7/1ASe/9SEnz/"
    "UxN8/1UTff9XFH3/WBV+/1oVfv9bFn7/XRd+/14Xf/9gGH//YRh//2MZf/9lGoD/ZhqA/2gbgP9pHID/axyA/2wd"
    "gP9uHoH/bx6B/3Efgf9zH4H/dCCB/3Yhgf93IYH/eSKB/3oigf98I4H/fiSB/38kgf+BJYH/giWB/4Qmgf+FJoH/"
    "hyeB/4kogf+KKIH/jCmA/40pgP+PKoD/kSqA/5IrgP+UK4D/lSyA/5csf/+ZLX//mi1//5wuf/+eLn7/ny9+/6Ev"
    "fv+jMH7/pDB9/6Yxff+nMX3/qTJ8/6szfP+sM3v/rjR7/7A0e/+xNXr/szV6/7U2ef+2Nnn/uDd4/7k3eP+7OHf/"
    "vTl3/745dv/AOnX/wjp1/8M7dP/FPHT/xjxz/8g9cv/KPnL/yz5x/80/cP/OQHD/0EFv/9FCbv/TQm3/1ENt/9ZE"
    "bP/XRWv/2UZq/9pHaf/cSGn/3Ulo/95KZ//gS2b/4Uxm/+JNZf/kTmT/5VBj/+ZRYv/nUmL/6FRh/+pVYP/rVmD/"
    "7Fhf/+1ZX//uW17/7l1d/+9eXf/wYF3/8WFc//JjXP/zZVz/82db//RoW//1alv/9Wxb//ZuW//2cFv/93Fb//dz"
    "XP/4dVz/+Hdc//l5XP/5e13/+X1d//p/Xv/6gF7/+oJf//uEYP/7hmD/+4hh//uKYv/8jGP//I5j//yQZP/8kmX/"
    "/JNm//2VZ//9l2j//Zlp//2bav/9nWv//Z9s//2hbv/9om///aRw//6mcf/+qHP//qp0//6sdf/+rnb//q94//6x"
    "ef/+s3v//rV8//63ff/+uX///ruA//68gv/+voP//sCF//7Chv/+xIj//saJ//7Hi//+yY3//suO//3NkP/9z5L/"
    "/dGT//3Slf/91Jf//daY//3Ymv/92pz//dyd//3dn//936H//eGj//zjpf/85ab//Oao//zoqv/86qz//Oyu//zu"
    "sP/88LH//PGz//zztf/89bf/+/e5//v5u//7+r3/+/y//w=="
)

_TERRAIN_B64 = (
    "AAB//wABgf8AA4P/AAWE/wAHhv8ACYj/AAqK/wAMjP8ADo3/ABCP/wASkf8AE5P/ABWV/wAXlv8AGZj/ABua/wAc"
    "nP8AHp7/ACCf/wAiof8AJKP/ACWl/wAnp/8AKaj/ACuq/wAtrP8ALq7/ADCw/wAysf8ANLP/ADa1/wA3t/8AObn/"
    "ADu6/wA9vP8AP77/AEDA/wBCwv8ARMP/AEbF/wBIx/8AScn/AEvL/wBNyv8ATsb/AE/D/wBQv/8AUbv/AFO4/wBU"
    "tP8AVbH/AFat/wBXqf8AWab/AFqi/wBbn/8AXJv/AF2X/wBflP8AYJD/AGGN/wBiif8AY4X/AGWC/wBmfv8AZ3v/"
    "AGh3/wBpc/8Aa3D/AGxs/wBtaP8AbmX/AG9h/wBxXv8Aclr/AHNW/wB0U/8AdU//AHdM/wB4SP8AeUT/AHpB/wB7"
    "Pf8AfTr/AH42/wB/Mv8BgDL/AoEx/wODMf8EhDD/BYUw/weGL/8Ihy7/CYku/wqKLf8Miyz/DYws/w6NK/8Pjyv/"
    "EJAq/xKRKv8Tkin/FJMo/xWVKP8Wlif/GJcn/xmYJv8amSX/G5sl/xycJP8enST/H54j/yCfIv8hoSL/IqIh/ySj"
    "IP8lpCD/JqUf/yenH/8oqB7/Kqke/yuqHf8sqxz/La0c/y6uG/8wrxv/MbAa/zKxGf80sRn/Nq8a/ziuGv87rBv/"
    "Paoc/0CoHP9Cph3/RaQe/0ejHv9JoR//TJ8f/06dIP9RmyH/U5oh/1WYIv9YliL/WpQj/12TJP9fkST/YY8l/2SN"
    "Jf9miyb/aYkn/2uIJ/9thij/cIQo/3KCKf90gSr/d38q/3l9K/98eyv/fnks/4F4Lf+Ddi3/hXQu/4hyLv+KcC//"
    "jW4w/49tMP+RazH/lGkx/5ZnMv+ZZjP/mmg2/5tqOv+cbT3/nW9B/59yRf+gdEj/oXZM/6J5T/+je1P/pH1W/6aA"
    "Wv+ngl7/qIVh/6mHZf+rimn/rIxs/62OcP+ukXP/r5N3/7GWe/+ymH7/s5qC/7Sdhf+1n4n/t6KN/7ikkP+5ppT/"
    "uqmX/7urm/+9rp//vrCi/7+ypv/Atan/wbet/8O6sf/EvLT/xb64/8bBu//Hw7//ycbD/8rIxv/Lysr/zMzM/83N"
    "zf/Pz8//0NDQ/9HR0f/S0tL/09PT/9XV1f/W1tb/19fX/9jY2P/Z2dn/29vb/9zc3P/d3d3/3t7e/9/f3//h4eH/"
    "4uLi/+Pj4//k5OT/5eXl/+fn5//o6Oj/6enp/+rq6v/r6+v/7e3t/+7u7v/v7+//8PDw//Hx8f/z8/P/9PT0//X1"
    "9f/29vb/9/f3//n5+f/6+vr/+/v7//z8/P/9/f3//////w=="
)


def palette_srgb_rgba8(name):
    """Return the (256, 4) uint8 sRGB-encoded RGBA palette for ``name``."""
    b64 = {"viridis": _VIRIDIS_B64, "magma": _MAGMA_B64, "terrain": _TERRAIN_B64}[name]
    raw = _b64.b64decode(b64)
    return _np.frombuffer(raw, dtype=_np.uint8).reshape(256, 4).copy()
