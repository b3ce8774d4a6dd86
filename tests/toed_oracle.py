"""Literal float64 NumPy oracle for the reference TOED detector.

Implements the exact semantics of /root/reference/src/toed/cpu_toed.cpp
(convolve_img :122-376, non_maximum_suppresion :386-582) as
straightforwardly as possible - scalar loops for NMS, direct tap summation
for the convolution - to serve as the golden model for the device kernels.

The filter taps below are the reference's hard-coded arrays
(cpu_toed.cpp:143-160), kept verbatim as golden DATA so the oracle is
independent of our formula-based generator (which is itself validated
against these numbers in test_filters.py).
"""

import numpy as np

GX = np.array([1.79817087452687e-05, 0.000133830225764885, 0.000763597358165040, 0.00332388630895351, 0.0109551878084803, 0.0269954832565940, 0.0485690983747094, 0.0604926811297858, 0.0440081658455374, 0, -0.0440081658455374, -0.0604926811297858, -0.0485690983747094, -0.0269954832565940, -0.0109551878084803, -0.00332388630895351, -0.000763597358165040, -0.000133830225764885, -1.79817087452687e-05])
G = np.array([7.99187055345274e-06, 6.69151128824427e-05, 0.000436341347522880, 0.00221592420596900, 0.00876415024678427, 0.0269954832565940, 0.0647587978329459, 0.120985362259572, 0.176032663382150, 0.199471140200716, 0.176032663382150, 0.120985362259572, 0.0647587978329459, 0.0269954832565940, 0.00876415024678427, 0.00221592420596900, 0.000436341347522880, 6.69151128824427e-05, 7.99187055345274e-06])
GXX = np.array([3.84608770384913e-05, 0.000250931673309160, 0.00122721003990810, 0.00443184841193801, 0.0115029471989044, 0.0202466124424455, 0.0202371243227956, 0, -0.0330061243841531, -0.0498677850501791, -0.0330061243841531, 0, 0.0202371243227956, 0.0202466124424455, 0.0115029471989044, 0.00443184841193801, 0.00122721003990810, 0.000250931673309160, 3.84608770384913e-05])
GXXX = np.array([7.75461189639711e-05, 0.000434948233735878, 0.00176581889075666, 0.00498582946343026, 0.00890109009439027, 0.00674887081414851, -0.00910670594525801, -0.0302463405648929, -0.0302556140188070, 0, 0.0302556140188070, 0.0302463405648929, 0.00910670594525801, -0.00674887081414851, -0.00890109009439027, -0.00498582946343026, -0.00176581889075666, -0.000434948233735878, -7.75461189639711e-05])
G_SH = np.array([2.38593182706025e-05, 0.000176297841183723, 0.00101452402864988, 0.00454678125079553, 0.0158698259178337, 0.0431386594132558, 0.0913245426945110, 0.150568716077402, 0.193334058401425, 0.193334058401425, 0.150568716077402, 0.0913245426945110, 0.0431386594132558, 0.0158698259178337, 0.00454678125079553, 0.00101452402864988, 0.000176297841183723, 2.38593182706025e-05, 2.51475364429622e-06])
GX_SH = np.array([5.07010513250303e-05, 0.000330558452219480, 0.00164860154655606, 0.00625182421984385, 0.0178535541575629, 0.0377463269865988, 0.0570778391840694, 0.0564632685290258, 0.0241667573001781, -0.0241667573001781, -0.0564632685290258, -0.0570778391840694, -0.0377463269865988, -0.0178535541575629, -0.00625182421984385, -0.00164860154655606, -0.000330558452219480, -5.07010513250303e-05, -5.97253990520353e-06])
GXX_SH = np.array([0.000101774904498039, 0.000575722637615595, 0.00242534650599113, 0.00745956298958641, 0.0161177919477999, 0.0222433712599600, 0.0128425138164156, -0.0164684533209659, -0.0453126699378339, -0.0453126699378339, -0.0164684533209659, 0.0128425138164156, 0.0222433712599600, 0.0161177919477999, 0.00745956298958641, 0.00242534650599113, 0.000575722637615595, 0.000101774904498039, 1.35560938637843e-05])
GXXX_SH = np.array([0.000190921146395817, 0.000914200719419500, 0.00311688729895755, 0.00713098700075939, 0.00920573886249338, 0.000589786359165606, -0.0205123484567749, -0.0344073042598751, -0.0177474623923183, 0.0177474623923183, 0.0344073042598751, 0.0205123484567749, -0.000589786359165606, -0.00920573886249338, -0.00713098700075939, -0.00311688729895755, -0.000914200719419500, -0.000190921146395817, -2.92094529738860e-05])


def _conv_phase(img, x_taps, y_taps, support):
    """f(i,j) = sum_{p,q in [-support, support]} img(i-p, j-q)
                 x_taps[q + 9] * y_taps[p + 9], zero outside."""
    H, W = img.shape
    out = np.zeros((H, W))
    for p in range(-support, support + 1):
        for q in range(-support, support + 1):
            w = x_taps[q + 9] * y_taps[p + 9]
            if w == 0.0:
                continue
            shifted = np.zeros((H, W))
            src_i0, src_i1 = max(0, -p), min(H, H - p)
            src_j0, src_j1 = max(0, -q), min(W, W - q)
            shifted[src_i0 + p:src_i1 + p, src_j0 + q:src_j1 + q] = \
                img[src_i0:src_i1, src_j0:src_j1]
            # shifted[i, j] = img[i - p, j - q]
            out += w * shifted
    return out


def oracle_gradient_field(img):
    """Returns (Ix, Iy, grad_mag, orient) as (2H, 2W) float64 arrays."""
    img = img.astype(np.float64)
    H, W = img.shape
    Ix = np.zeros((2 * H, 2 * W))
    Iy = np.zeros_like(Ix)
    mag = np.zeros_like(Ix)
    orient = np.zeros_like(Ix)

    derivs = [("fx", "Gx", "G"), ("fy", "G", "Gx"), ("fxx", "Gxx", "G"),
              ("fxy", "Gx", "Gx"), ("fyy", "G", "Gxx"), ("fxxy", "Gxx", "Gx"),
              ("fxyy", "Gx", "Gxx"), ("fxxx", "Gxxx", "G"), ("fyyy", "G", "Gxxx")]
    banks = {("G", 0): G, ("Gx", 0): GX, ("Gxx", 0): GXX, ("Gxxx", 0): GXXX,
             ("G", 1): G_SH, ("Gx", 1): GX_SH, ("Gxx", 1): GXX_SH,
             ("Gxxx", 1): GXXX_SH}

    for sy in (0, 1):
        for sx in (0, 1):
            support = 8 if (sx == 0 and sy == 0) else 9
            f = {}
            for name, xb, yb in derivs:
                f[name] = _conv_phase(img, banks[(xb, sx)], banks[(yb, sy)],
                                      support)
            fx, fy = f["fx"], f["fy"]
            gm = np.sqrt(fx**2 + fy**2)
            tix = (fx * (2 * f["fxx"]**2 + 2 * f["fxy"]**2)
                   + fy * (2 * f["fxx"] * f["fxy"] + 2 * f["fyy"] * f["fxy"])
                   + 2 * fx * fy * f["fxxy"] + fy**2 * f["fxyy"]
                   + fx**2 * f["fxxx"])
            tiy = (fx * (2 * f["fxx"] * f["fxy"] + 2 * f["fyy"] * f["fxy"])
                   + fy * (2 * f["fyy"]**2 + 2 * f["fxy"]**2)
                   + 2 * fx * fy * f["fxyy"] + fx**2 * f["fxxy"]
                   + fy**2 * f["fyyy"])
            tm = np.sqrt(tix**2 + tiy**2)
            with np.errstate(invalid="ignore", divide="ignore"):
                ori = np.arctan2(tix / tm, -tiy / tm)
            Ix[sy::2, sx::2] = fx
            Iy[sy::2, sx::2] = fy
            mag[sy::2, sx::2] = gm
            orient[sy::2, sx::2] = ori
    return Ix, Iy, mag, orient


def oracle_nms(Ix, Iy, mag, orient, img_height, img_width):
    """Literal port of non_maximum_suppresion (cpu_toed.cpp:386-582).
    Returns list of (x, y, theta) edges in reference raster order."""
    iH, iW = mag.shape
    sn = 1
    subpix_x = np.zeros((iH, iW))
    subpix_y = np.zeros((iH, iW))
    submag = np.zeros((iH, iW))
    for j in range(10, iW - 10):
        for i in range(10, iH - 10):
            g = mag[i, j]
            if g <= 2:
                continue
            if abs(Ix[i, j]) < 1e-5 and abs(Iy[i, j]) < 1e-5:
                continue
            ndx = Ix[i, j] / g
            ndy = Iy[i, j] / g
            gx, gy = Ix[i, j], Iy[i, j]
            m = mag
            if gx >= 0 and gy >= 0:
                if gx >= gy:
                    sl = ndy / ndx
                    fp = m[i, j + sn] * (1 - sl) + m[i + sn, j + sn] * sl
                    fm = m[i, j - sn] * (1 - sl) + m[i - sn, j - sn] * sl
                else:
                    sl = ndx / ndy
                    fp = m[i + sn, j] * (1 - sl) + m[i + sn, j + sn] * sl
                    fm = m[i - sn, j] * (1 - sl) + m[i - sn, j - sn] * sl
            elif gx < 0 and gy >= 0:
                if abs(gx) < gy:
                    sl = -ndx / ndy
                    fp = m[i + sn, j] * (1 - sl) + m[i + sn, j - sn] * sl
                    fm = m[i - sn, j] * (1 - sl) + m[i - sn, j + sn] * sl
                else:
                    sl = -ndy / ndx
                    fp = m[i, j - sn] * (1 - sl) + m[i + sn, j - sn] * sl
                    fm = m[i, j + sn] * (1 - sl) + m[i - sn, j + sn] * sl
            elif gx < 0 and gy < 0:
                if abs(gx) >= abs(gy):
                    sl = ndy / ndx
                    fp = m[i, j - sn] * (1 - sl) + m[i - sn, j - sn] * sl
                    fm = m[i, j + sn] * (1 - sl) + m[i + sn, j + sn] * sl
                else:
                    sl = ndx / ndy
                    fp = m[i - sn, j] * (1 - sl) + m[i - sn, j - sn] * sl
                    fm = m[i + sn, j] * (1 - sl) + m[i + sn, j + sn] * sl
            else:
                if gx < abs(gy):
                    sl = -ndx / ndy
                    fp = m[i - sn, j] * (1 - sl) + m[i - sn, j + sn] * sl
                    fm = m[i + sn, j] * (1 - sl) + m[i + sn, j - sn] * sl
                else:
                    sl = -ndy / ndx
                    fp = m[i, j + sn] * (1 - sl) + m[i - sn, j + sn] * sl
                    fm = m[i, j - sn] * (1 - sl) + m[i + sn, j - sn] * sl

            s = np.sqrt(1 + sl * sl)
            if (g > fm and g > fp) or (g > fm and g >= fp) or (g >= fm and g > fp):
                A = (fm + fp - 2 * g) / (2 * s * s)
                B = (fp - fm) / (2 * s)
                with np.errstate(invalid="ignore", divide="ignore"):
                    s_star = -B / (2 * A)
                    max_f = A * s_star**2 + B * s_star + g
                if abs(s_star) <= np.sqrt(2):
                    subpix_x[i, j] = j + s_star * ndx
                    subpix_y[i, j] = i + s_star * ndy
                    sgx = max_f * ndx
                    sgy = max_f * ndy
                    submag[i, j] = np.sqrt(sgx**2 + sgy**2)

    edges = []
    for i in range(10, iH - 10):
        for j in range(10, iW - 10):
            if subpix_x[i, j] != 0:
                ex = (subpix_x[i, j] - 1) / 2
                ey = (subpix_y[i, j] - 1) / 2
                if 10 < ex < img_width - 10 and 10 < ey < img_height - 10:
                    edges.append((ex, ey, orient[i, j], submag[i, j]))
    return edges


def oracle_detect(img):
    Ix, Iy, mag, orient = oracle_gradient_field(img)
    return oracle_nms(Ix, Iy, mag, orient, img.shape[0], img.shape[1])
