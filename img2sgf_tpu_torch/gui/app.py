"""Tkinter GUI: three-pane editor over the PyTorch detection pipeline (port
of img2sgf_tpu/gui/app.py).

Faithful to the reference's layout and interaction contract
(img2sgf.py:1005-1254): input / processed / board panes, zoom by
click-drag with double-click reset, rotate + contrast/brightness + line
threshold sliders, cluster diagnostics plot, draggable black-stone
threshold histogram, scrolling log window, board editor with stone
cycling, alignment dots for partial boards, save/reset buttons.

All compute goes through gui.session.DetectSession -> the pipeline on the
session's device; this module only draws, from the session's host copy of
each result. Tk and matplotlib are imported inside run_gui only, so the
package imports where neither is installed.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import BLACK, WHITE, Alignment, BoardStates
from ..hostio import load_rgb, screen_capture
from .session import DetectSession

IMAGE_SIZE = 400
BORDER = 20


def canvas_fit_scale(img_w, img_h, canvas_w, canvas_h):
    """Uniform scale that fits an image inside a canvas (reference
    get_scale, img2sgf.py:579-585: min of the two axis ratios)."""
    cw = max(canvas_w, 1)
    ch = max(canvas_h, 1)
    return min(cw / img_w, ch / img_h)


def board_click_action(x, y, w, h, hsize, vsize):
    """Classify a click on the board canvas (reference edit_board geometry,
    img2sgf.py:955-1001).

    Returns ("cycle", i, j) for a click on/near the grid,
    ("align", horiz, vert) for an alignment-dot region hit on a partial
    board (each of horiz/vert is an Alignment or None = unchanged; both
    None means the click landed in a dead zone), mirroring the reference's
    board_alignment update rules exactly — including the corner case that
    requires the click to be outside BOTH the x and y band, and the
    side-position 24px-wide centre strip (min(w,h)/2 +- 12).
    """
    cmin, cmax = 30, min(w, h) - 30
    gs = (cmax - cmin) / 18
    if cmin - gs / 2 < x < cmax + gs / 2 and cmin - gs / 2 < y < cmax + gs / 2:
        i = round((x - cmin) / (cmax - cmin) * 18)
        j = round((y - cmin) / (cmax - cmin) * 18)
        return ("cycle", i, j)
    c1, c2 = min(w, h) / 2 - 12, min(w, h) / 2 + 12
    horiz = vert = None
    if hsize < 19 and vsize < 19:
        if not (cmin < x < cmax or cmin < y < cmax):
            horiz = Alignment.LEFT if x < cmin else Alignment.RIGHT
            vert = Alignment.TOP if y < cmin else Alignment.BOTTOM
    elif vsize < 19 and c1 < x < c2:
        vert = Alignment.TOP if y < cmin else Alignment.BOTTOM
    elif hsize < 19 and c1 < y < c2:
        horiz = Alignment.LEFT if x < cmin else Alignment.RIGHT
    return ("align", horiz, vert)


def hist_pixel_to_data(ax, px, py, widget_height):
    """Map a Tk mouse position on the histogram widget to data coords
    (reference scale_brightness, img2sgf.py:744-748): Tk y runs from the
    top, matplotlib display coords from the bottom."""
    return ax.transData.inverted().transform((px, widget_height - py))[0]


def run_gui(input_path=None, output_path=None, device="cuda") -> int:
    """Open the editor (optionally on input_path; output_path is the save
    dialog's default) with detection on `device`; returns 0 when the window
    closes. Raises before opening a window if `device` is a card that is
    not there."""
    from ..pipeline.detect import resolve_device

    dev = resolve_device(device)

    import tkinter as tk
    from tkinter import filedialog, messagebox
    from tkinter import scrolledtext

    from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
    from matplotlib.figure import Figure
    from PIL import Image, ImageTk

    main = tk.Tk()
    main.configure(background="#FFFFC0")
    main.title("Image to SGF")
    main.geometry(f"{3 * IMAGE_SIZE + 4 * BORDER}x{IMAGE_SIZE + 230 + 3 * BORDER}")

    # --- log window ----------------------------------------------------
    log_window = tk.Toplevel()
    log_window.title("Img2SGF log")
    log_text = scrolledtext.ScrolledText(log_window, undo=True)
    log_text.pack(expand=True, fill="both")
    log_window.withdraw()
    log_visible = [False]

    def log(msg):
        log_text.insert(tk.END, str(msg) + "\n")
        log_text.see(tk.END)

    session = DetectSession(log=log, device=dev)
    output_file = [output_path]

    # --- frames --------------------------------------------------------
    frames = [tk.Frame(main) for _ in range(3)]
    for col, fr in enumerate(frames):
        fr.grid(row=0, column=col, pady=BORDER)
    main.rowconfigure(1, weight=1)
    for c in range(3):
        main.columnconfigure(c, weight=1)

    input_canvas = tk.Canvas(main)
    input_canvas.grid(row=1, column=0, sticky="nsew", padx=BORDER, pady=BORDER)
    processed_canvas = tk.Canvas(main)
    processed_canvas.grid(row=1, column=1, sticky="nsew", pady=BORDER)
    output_canvas = tk.Canvas(main)
    output_canvas.grid(row=1, column=2, sticky="nsew", padx=BORDER, pady=BORDER)

    photos = {}  # keep PhotoImage refs alive

    # --- settings window ----------------------------------------------
    settings = tk.Toplevel()
    settings.title("Img2SGF settings")
    settings.geometry("900x500")
    settings_visible = [False]
    s1 = tk.Frame(settings)
    s1.grid(row=0, column=0, sticky="nsew", padx=(0, 5))
    s2 = tk.Frame(settings)
    s2.grid(row=0, column=1, sticky="nsew", padx=(5, 0))
    settings.columnconfigure(0, weight=1)
    settings.columnconfigure(1, weight=1)
    settings.rowconfigure(0, weight=1)

    tk.Label(s1, text="Contrast").grid(row=0, sticky="nsew")
    contrast = tk.Scale(s1, from_=0, to=100, orient=tk.HORIZONTAL)
    contrast.set(70)
    contrast.grid(row=1, padx=15, sticky="nsew")
    tk.Label(s1, text="Brightness").grid(row=2, padx=15, sticky="nsew")
    brightness = tk.Scale(s1, from_=0, to=100, orient=tk.HORIZONTAL)
    brightness.set(50)
    brightness.grid(row=3, padx=15, sticky="nsew")

    tk.Label(s2, text="line detection threshold\nfor Hough transform").grid(
        row=0, pady=(40, 0), padx=15, sticky="nsew"
    )
    threshold = tk.Scale(s2, from_=1, to=500, orient=tk.HORIZONTAL)
    threshold.set(80)
    threshold.grid(row=1, pady=(7, 71), padx=15, sticky="nsew")

    fig1 = Figure(figsize=(3, 2), dpi=130)
    cluster_ax = fig1.add_subplot(1, 1, 1)
    cluster_ax.axis("off")
    cluster_plot = FigureCanvasTkAgg(fig1, master=s2)
    cluster_plot.get_tk_widget().grid(row=2, padx=15, sticky="nsew")
    s2.rowconfigure(2, weight=1)

    tk.Label(s1, text="black stone detection").grid(row=4, pady=(30, 20), padx=15)
    fig2 = Figure(figsize=(3, 2), dpi=130)
    hist_ax = fig2.add_subplot(1, 1, 1)
    hist_canvas_agg = FigureCanvasTkAgg(fig2, master=s1)
    hist_widget = hist_canvas_agg.get_tk_widget()
    hist_widget.grid(row=5, padx=15, sticky="nsew")
    s1.rowconfigure(5, weight=1)
    settings.withdraw()

    # --- drawing -------------------------------------------------------
    def scale_to(img: Image.Image, canvas):
        s = canvas_fit_scale(img.size[0], img.size[1],
                             canvas.winfo_width(), canvas.winfo_height())
        resized = img.resize((max(1, round(img.size[0] * s)), max(1, round(img.size[1] * s))))
        return ImageTk.PhotoImage(resized), s

    sel_rect = [None]

    def draw_images(*_):
        if not session.image_loaded or session.region_rgb is None:
            return
        img = Image.fromarray(session.region_rgb)
        photos["input"], _ = scale_to(img, input_canvas)
        input_canvas.delete("all")
        input_canvas.create_image(0, 0, image=photos["input"], anchor="nw")
        sel_rect[0] = input_canvas.create_rectangle(
            0, 0, 0, 0, dash=(6, 6), fill="", outline="green", width=3
        )

        res = session.result
        if res is None:
            return
        processed_canvas.delete("all")
        if show_circles.get() == 1:
            base = Image.fromarray(np.asarray(res.edges))
        else:
            base = Image.fromarray(np.asarray(res.circles_removed))
        photos["processed"], s = scale_to(base, processed_canvas)
        processed_canvas.create_image(0, 0, image=photos["processed"], anchor="nw")

        if show_circles.get() == 1:
            circ = np.asarray(res.circles)[np.asarray(res.circles_valid)]
            for x, y, r in circ:
                processed_canvas.create_oval(
                    (x - r) * s, (y - r) * s, (x + r) * s, (y + r) * s, outline="orange"
                )
        hc = np.asarray(res.hcentres)[: int(res.hcount)]
        vc = np.asarray(res.vcentres)[: int(res.vcount)]
        if len(hc) and len(vc):
            vl = np.asarray(res.vlines)[np.asarray(res.vlines_valid)]
            hl = np.asarray(res.hlines)[np.asarray(res.hlines_valid)]
            if len(vl) and len(hl):
                xmin, xmax = vl.min() * s, vl.max() * s
                ymin, ymax = hl.min() * s, hl.max() * s
                if bool(res.valid_grid):
                    for y in np.asarray(res.hcentres_complete)[: int(res.vsize)]:
                        processed_canvas.create_line(xmin, y * s, xmax, y * s, fill="red", width=2)
                    for x in np.asarray(res.vcentres_complete)[: int(res.hsize)]:
                        processed_canvas.create_line(x * s, ymin, x * s, ymax, fill="red", width=2)
                for y in hc:
                    processed_canvas.create_line(xmin, y * s, xmax, y * s, fill="green", width=2)
                for x in vc:
                    processed_canvas.create_line(x * s, ymin, x * s, ymax, fill="green", width=2)

    def draw_cluster_plot():
        # each cluster's member lines plot in ONE color (img2sgf.py:315-322
        # colors by clusters.labels_); membership is re-derived with the
        # same gap-cut rule as grid.cluster.cluster_1d (sorted points, new
        # cluster where the neighbour gap >= min_grid_spacing)
        cluster_ax.clear()
        res = session.result
        if res is not None:
            colours = 10 * ["r", "g", "b", "c", "k", "y", "m"]
            spacing = session.cfg.min_grid_spacing

            def cluster_ids(sorted_vals):
                if not len(sorted_vals):
                    return np.zeros(0, int)
                return np.concatenate(
                    [[0], np.cumsum(np.diff(sorted_vals) >= spacing)]
                ).astype(int)

            hl = np.sort(np.asarray(res.hlines)[np.asarray(res.hlines_valid)])
            vl = np.sort(np.asarray(res.vlines)[np.asarray(res.vlines_valid)])
            hc = np.asarray(res.hcentres)[: int(res.hcount)]
            vc = np.asarray(res.vcentres)[: int(res.vcount)]
            if len(hl):
                ymin, ymax = hl.min(), hl.max()
                for cid, y in zip(cluster_ids(hl), hl):
                    cluster_ax.plot(ymin, y, color=colours[cid % len(colours)], marker=".")
                for x in vc:
                    cluster_ax.plot((x, x), (ymin, ymax), "green", linewidth=1)
            if len(vl):
                xmin, xmax = vl.min(), vl.max()
                for cid, x in zip(cluster_ids(vl), vl):
                    cluster_ax.plot(x, xmin, color=colours[cid % len(colours)], marker=".")
                for y in hc:
                    cluster_ax.plot((xmin, xmax), (y, y), color="green", linewidth=1)
        cluster_plot.draw()

    def draw_histogram():
        hist_ax.clear()
        if session.board_ready:
            sb = session.stone_brightnesses()
            if len(sb):
                counts, _, _ = hist_ax.hist(sb, bins=20, range=[0, 255], color="pink")
                mx = max(counts.max(), 1)
                t = session.black_stone_threshold
                hist_ax.plot([t, t], [0, mx], color="red")
                hist_ax.text(t, mx * 0.95, str(int(t)), fontsize=8)
                nb = int((sb <= t).sum())
                hist_ax.text(t - 70, mx * 0.8, f"{nb} black", fontsize=8)
                hist_ax.text(t + 10, mx * 0.8, f"{len(sb) - nb} white", fontsize=8)
        hist_canvas_agg.draw()

    def draw_board(*_):
        output_canvas.configure(bg="#d9d9d9")
        output_canvas.delete("all")
        if not session.board_ready or session.full_board is None:
            if session.image_loaded:
                for k, line in enumerate(
                    ["Board not detected!", "Things to try:", "- Select a smaller region",
                     "- Rotate the image", "- Show settings", "  -> Increase contrast",
                     "  -> Increase threshold"]
                ):
                    output_canvas.create_text((0, 30 * k), text=line, anchor="nw")
            return
        output_canvas.configure(bg="#FFC050")
        w, h = output_canvas.winfo_width(), output_canvas.winfo_height()
        s = min(w, h)
        if s < 220:
            output_canvas.create_text((0, 0), text="Too small!", anchor="nw")
            return
        width = s - 60
        r = width / 18 / 2.1
        coords = [i * width / 18 + 30 for i in range(19)]
        cmin, cmax = min(coords), max(coords)
        for c in coords:
            output_canvas.create_line(c, cmin, c, cmax)
            output_canvas.create_line(cmin, c, cmax, c)
        for i in (3, 9, 15):
            for j in (3, 9, 15):
                output_canvas.create_oval(
                    coords[i] - 2, coords[j] - 2, coords[i] + 2, coords[j] + 2, fill="black"
                )
        for i in range(19):
            for j in range(19):
                st = session.full_board[i, j]
                if st in (BoardStates.BLACK, BoardStates.WHITE):
                    x, y = coords[i], coords[j]
                    output_canvas.create_oval(
                        x - r, y - r, x + r, y + r,
                        fill="black" if st == BoardStates.BLACK else "white",
                    )
        hsize = int(session.result.hsize)
        vsize = int(session.result.vsize)
        pos = []
        if hsize < 19 and vsize < 19:
            pos = [(15, 15), (15, width + 45), (width + 45, 15), (width + 45, width + 45)]
        elif hsize < 19:
            pos = [(15, coords[9]), (width + 45, coords[9])]
        elif vsize < 19:
            pos = [(coords[9], 15), (coords[9], width + 45)]
        for i, j in pos:
            output_canvas.create_oval(i - 2, j - 2, i + 2, j + 2, fill="pink")
            output_canvas.create_oval(i - 8, j - 8, i + 8, j + 8)

    def redraw_all():
        draw_images()
        draw_cluster_plot()
        draw_histogram()
        draw_board()
        save_button.configure(state=tk.ACTIVE if session.board_ready else tk.DISABLED)
        if session.board_ready:
            side_var.set(session.side_to_move)

    # --- processing hooks ---------------------------------------------
    def sync_and_process(*_):
        if not session.image_loaded:
            return
        session.contrast = contrast.get()
        session.brightness = brightness.get()
        session.line_threshold = threshold.get()
        session.rotate_deg = rotate.get()
        session.process()
        redraw_all()

    def open_file(path=None):
        if path is None:
            path = filedialog.askopenfilename()
        if not path:
            return
        from datetime import datetime

        log("\n" + datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
        log("Opening file " + path)
        try:
            rgb = load_rgb(path)
        except Exception:
            log("Error: not a valid image file")
            messagebox.showinfo("Can't open file", f"{path} isn't a valid image file")
            return
        log(f"Image size {rgb.shape[1]}x{rgb.shape[0]}")
        session.load_image(rgb)
        contrast.set(int(session.contrast))
        brightness.set(int(session.brightness))
        threshold.set(int(session.line_threshold))
        rotate.set(0)
        session.process()
        redraw_all()

    def capture():
        main.state("iconic")
        rgb = screen_capture()
        main.state("normal")
        log("Screen capture")
        session.load_image(rgb)
        threshold.set(int(session.line_threshold))
        session.process()
        redraw_all()

    # --- zoom selection -----------------------------------------------
    sel_local = [0, 0, 0, 0]

    def sel_start(ev):
        sel_local[:] = [ev.x, ev.y, ev.x, ev.y]

    def sel_update(ev):
        if not session.image_loaded or sel_rect[0] is None:
            return
        sel_local[2:] = [ev.x, ev.y]
        input_canvas.coords(sel_rect[0], *sel_local)

    def sel_done(_ev):
        if session.select_region(
            sel_local, (input_canvas.winfo_width(), input_canvas.winfo_height())
        ):
            threshold.set(int(session.line_threshold))
            redraw_all()

    def zoom_out(_ev):
        session.zoom_out()
        # zoom_out is a full parameter reset (img2sgf.py:736-640): sync
        # every slider, not just the line threshold
        contrast.set(int(session.contrast))
        brightness.set(int(session.brightness))
        threshold.set(int(session.line_threshold))
        rotate.set(0)
        redraw_all()

    input_canvas.bind("<Button-1>", sel_start)
    input_canvas.bind("<B1-Motion>", sel_update)
    input_canvas.bind("<ButtonRelease-1>", sel_done)
    input_canvas.bind("<Double-Button-1>", zoom_out)
    input_canvas.bind("<Configure>", draw_images)
    output_canvas.bind("<Configure>", draw_board)

    # --- histogram threshold drag -------------------------------------
    def hist_set(ev):
        if not session.board_ready:
            return
        x_data = hist_pixel_to_data(hist_ax, ev.x, ev.y, hist_widget.winfo_height())
        xmin, xmax = hist_ax.get_xlim()
        if 0 <= x_data <= xmax:
            session.black_stone_threshold = int(x_data)
            hist_ax.set_xlim((xmin, xmax))
            draw_histogram()

    def hist_apply(_ev):
        if not session.board_ready:
            return
        session.reclassify()
        side_var.set(session.side_to_move)
        draw_board()

    hist_widget.bind("<Button-1>", hist_set)
    hist_widget.bind("<B1-Motion>", hist_set)
    hist_widget.bind("<ButtonRelease-1>", hist_apply)

    # --- board editing -------------------------------------------------
    def edit_board(ev):
        if not session.board_ready:
            return
        w, h = output_canvas.winfo_width(), output_canvas.winfo_height()
        act = board_click_action(
            ev.x, ev.y, w, h,
            int(session.result.hsize), int(session.result.vsize))
        if act[0] == "cycle":
            session.cycle_stone(act[1], act[2], right_click=(ev.num == 3))
            reset_button.configure(state=tk.ACTIVE)
        elif session.set_alignment(act[1], act[2]):
            reset_button.configure(state=tk.DISABLED)
        draw_board()

    output_canvas.bind("<ButtonRelease-1>", edit_board)
    output_canvas.bind("<ButtonRelease-3>", edit_board)

    # --- buttons / toggles --------------------------------------------
    def toggle(window, visible, button, label):
        if visible[0]:
            window.withdraw()
            visible[0] = False
            button.configure(text=f"show {label}")
        else:
            window.deiconify()
            visible[0] = True
            button.configure(text=f"hide {label}")

    def save_sgf():
        out = filedialog.asksaveasfilename(
            initialfile=output_file[0] if output_file[0] else ""
        )
        if not out:
            return
        with open(out, "w") as f:
            f.write(session.sgf_text())
        output_file[0] = out
        log("Saved to file " + out)

    def reset_board():
        session.apply_alignment()
        reset_button.configure(state=tk.DISABLED)
        draw_board()

    tk.Label(frames[0], text="Input image").grid(row=0, columnspan=2, pady=10)
    tk.Button(frames[0], text="open", command=open_file).grid(row=1, column=0)
    tk.Button(frames[0], text="capture", command=capture).grid(row=1, column=1)
    tk.Label(frames[0], text="click and drag to zoom\ndouble-click to reset").grid(
        row=2, columnspan=2, pady=10
    )

    tk.Label(frames[1], text="Processed image").grid(row=0, columnspan=2, pady=10)
    settings_button = tk.Button(
        frames[1], text="show settings",
        command=lambda: toggle(settings, settings_visible, settings_button, "settings"),
    )
    settings_button.grid(row=1, column=0)
    log_button = tk.Button(
        frames[1], text="show log",
        command=lambda: toggle(log_window, log_visible, log_button, "log"),
    )
    log_button.grid(row=1, column=1)
    show_circles = tk.IntVar()
    show_circles.set(1)
    tk.Checkbutton(
        frames[1], text="show detected circles", variable=show_circles, command=draw_images
    ).grid(row=2, pady=10)
    tk.Label(frames[1], text="rotate").grid(row=3, columnspan=2)
    rotate = tk.Scale(frames[1], from_=-45, to=45, orient=tk.HORIZONTAL, length=IMAGE_SIZE)
    rotate.grid(row=4, columnspan=2, sticky="ew")
    rotate.bind("<ButtonRelease-1>", sync_and_process)
    contrast.bind("<ButtonRelease-1>", sync_and_process)
    brightness.bind("<ButtonRelease-1>", sync_and_process)
    threshold.bind("<ButtonRelease-1>", sync_and_process)

    tk.Label(frames[2], text="Detected board position").grid(row=0, columnspan=2, pady=10)
    save_button = tk.Button(frames[2], text="save", command=save_sgf, state=tk.DISABLED)
    save_button.grid(row=1, column=0)
    reset_button = tk.Button(frames[2], text="reset", command=reset_board, state=tk.DISABLED)
    reset_button.grid(row=1, column=1)
    tk.Label(
        frames[2],
        text="Click on board to change between empty,\nblack stone and white stone.\n\n"
        "For side/corner positions,\nclick on circle outside board\nto choose which side/corner.",
    ).grid(row=2, columnspan=2, pady=(10, 0))

    stm = tk.Frame(frames[2])
    stm.grid(row=3)
    side_var = tk.IntVar()
    side_var.set(BLACK)

    def set_side(*_):
        session.side_to_move = side_var.get()

    tk.Radiobutton(stm, text="black", variable=side_var, value=BLACK, command=set_side).pack(side=tk.LEFT)
    tk.Radiobutton(stm, text="white", variable=side_var, value=WHITE, command=set_side).pack(side=tk.LEFT)
    tk.Label(stm, text="to play").pack(side=tk.LEFT)

    # startup banner with library versions (img2sgf.py:1240-1254 logs the
    # version of every dependency, each wrapped in its own try/except)
    import torch

    from .. import __version__

    log(f"img2sgf_tpu_torch {__version__} — PyTorch/CUDA port of img2sgf")
    log("Device: " + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else str(dev)))
    for label, get in (
        ("Tk", lambda: tk.TkVersion),
        ("torch", lambda: torch.__version__),
        ("numpy", lambda: np.__version__),
        ("Pillow", lambda: __import__("PIL").__version__),
        ("matplotlib", lambda: __import__("matplotlib").__version__),
    ):
        try:
            log(f"{label} version {get()}")
        except Exception:
            log(f"Can't find {label} version")

    # widget handles for event-driven tests (tests/test_gui_events.py
    # drives these with event_generate when a display exists)
    main.testing_handles = dict(
        session=session, input_canvas=input_canvas,
        output_canvas=output_canvas, hist_widget=hist_widget,
        hist_ax=hist_ax, reset_button=reset_button,
        save_button=save_button, threshold=threshold, settings=settings,
    )

    if input_path:
        main.after(100, lambda: open_file(input_path))
    main.mainloop()
    return 0
